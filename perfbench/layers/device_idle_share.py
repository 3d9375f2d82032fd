"""Share of the window (%) in which no device activity ran: 1 - the
union of the CUPTI activity intervals over the traced window.  Layer:
the device, under any entry; the reader of device_idle_share.<entry>."""


def read(ctx):
    if ctx.device is None or ctx.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.device.busy_s / ctx.device.window_s)
