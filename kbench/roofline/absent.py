"""The entry of a kernel family whose function the program under test does
not have (a program older than the family): the tracer wraps it as it wraps
any entry, nothing calls it, and the family reads nothing in that run."""


def entry(*args, **kwargs):
    raise RuntimeError("the program has no function behind this kernel family")
