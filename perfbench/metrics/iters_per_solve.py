"""iters_per_solve: executed iterations summed over the window's solves (a
path's lanes each count), over their number; from the program's
final_iter."""


def read(ctx):
    iters = [i for r in ctx.records for i in r["iters"]]
    return sum(iters) / len(iters) if iters else None
