"""setup_s: seconds from the start of the process to the window — the
imports, the kernel libraries, the system's set-up and its warm-up."""


def read(run):
    return run.setup_s
