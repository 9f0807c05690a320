"""decode_step_ms: the mean device milliseconds of one decode step (page
allocation, the forward over every layer, sampling and retirement):
``serve.step``'s ``decode`` phases, between the graph's consecutive events
of the burst, over every step of every profiler-free tick, in the serving
cells."""
from bench import program


def read(run):
    return program.mean(program.phase_ms(run, "decode"))
