"""Public problem builders."""
