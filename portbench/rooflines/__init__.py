"""One module a kernel, `<kernel>.py`: the least bytes (and operations)
the kernel's launches need, computed from shapes, never from a counter of
the program."""
