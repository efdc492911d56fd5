"""``step.launches_per_block``: kernel launches the host made a block
(the runtime's and the driver's launch calls in the profiler's trace,
every kernel of the port's and of torch's), over the traced blocks.
Layer: the telemetry step and the ops it calls."""


def read(run):
    tr = run.trace
    if tr is None or tr.blocks <= 0 or not tr.launches:
        return None
    return tr.launches / tr.blocks
