"""Every program runs eagerly: the reference captures no CUDA graph."""


def run(tag, fn, *inputs):
    return fn(*inputs)
