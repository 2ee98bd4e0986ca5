"""Seconds from the start of the process to the start of the window:
imports, the kernel library (built in the checkout on a first run,
loaded after), the weights drawn and loaded, the inputs, the warm-up."""


def read(run):
    return run.setup_s
