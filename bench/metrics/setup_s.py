"""setup_s: seconds from the process's start to the window's start
(imports, the kernel library's load or build, the weights, the warm-up's
captures and the lead-in traffic). Host clock."""


def read(run):
    return run.setup_s
