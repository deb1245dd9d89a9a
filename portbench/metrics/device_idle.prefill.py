"""device_idle.prefill: the share of the traced window of sealed prefills
(one batch of each of the cell's lengths, back to back) in which no
kernel, copy or set ran on the card, in %.  None without a device
event."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100 * (1 - r.trace.busy_s / r.trace.window_s)
