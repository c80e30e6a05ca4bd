"""device_idle_pct [%], layer device: the share of the analysed interval
in which no kernel, copy or memset runs on a card, the mean over the
cards."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s() / run.device.window_s)
