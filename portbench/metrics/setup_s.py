"""setup_s (end-to-end, host_clock, s, lower): what every run pays
before serving: from the process's start through the inputs, the
bootstrap (static solve, tuner, host pack, walk index) and the warm-up
batches, to the window's opening."""


def read(run):
    return run["setup_s"]
