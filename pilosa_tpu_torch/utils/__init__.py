"""Host utilities: durations, the logger and Prometheus rendering (the
port's copies of ``pilosa_tpu.utils``'s JAX-free modules)."""


def as_int_list(seq) -> list:
    """Python ints from any id sequence: ``.tolist()`` converts a numpy
    buffer in C, where a per-element ``int()`` loop costs more than the
    frame it fills."""
    tolist = getattr(seq, "tolist", None)
    if tolist is not None:
        return tolist()
    return [int(v) for v in seq]
