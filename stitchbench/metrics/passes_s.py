"""Host seconds of the port's pass pipeline, planning and code generation:
its outermost ``pass.*`` and ``verify`` spans (``repro_torch.tracing``), less
the ``build`` spans inside them, which ``build_s`` reads."""
from stitchbench import spans


def read(run):
    passes = spans.seconds(lambda s, by_id: spans.is_pass(s.name)
                           and not spans.under_a_pass(s, by_id))
    if passes is None:
        return None
    builds = spans.seconds(lambda s, by_id: s.name == "build" and spans.under_a_pass(s, by_id))
    return passes - (builds or 0.0)
