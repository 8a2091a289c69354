"""setup_s (s, host clock): from the process's start to the window's first
call: imports, the cards' start, the kernel build where it has not run in
this checkout, the pool made and loaded, one warm round trip a file."""


def read(run):
    return run.setup_s
