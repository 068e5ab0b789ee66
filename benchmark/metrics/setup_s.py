"""Set-up seconds: from the process's start to the window's, the program
imported, its kernel built or loaded, the scene made and one request run
(host clock)."""


def read(run):
    return run.setup_s
