"""Entity updates a second: the active entities times the ticks whose
events all reached the host in the window, over the window's time (host
clock). The AOI capacity of one game process, or of the whole
multi-process world."""


def read(run):
    return run.active() * run.ticks() / run.window_s()
