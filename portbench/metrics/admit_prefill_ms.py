"""admit_prefill_ms: the mean device milliseconds of an admit tick's
phases 2-3 (the lanes' activation, the padded prefill of every lane and
the page writes): ``serve.step``'s ``prefill`` phase, between the admit
graph's events after phase 1 and after phase 3, over the profiler-free
admit ticks, in the serving cells."""
from bench import program


def read(run):
    return program.mean(program.phase_ms(run, "prefill"))
