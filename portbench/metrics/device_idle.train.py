"""device_idle.train: the share of the traced window of training steps
(two after the window, each with its sealed batch) in which no kernel,
copy or set ran on the card, in %.  None without a device event."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100 * (1 - r.trace.busy_s / r.trace.window_s)
