"""The graphs the program captured over the run, every slot
(``render.graphs.CAPTURES``), read in a traced run."""


def read(ctx):
    if ctx.device_trace is None:
        return None
    from tpu_pathtracer_torch.render import graphs
    captures = getattr(graphs, "CAPTURES", None)
    return None if captures is None else sum(captures.values())
