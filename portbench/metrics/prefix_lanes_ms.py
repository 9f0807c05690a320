"""prefix_lanes_ms: the mean device milliseconds of an admit tick's phase 1,
the prefix cache's admission lanes (block hashing, one slot-returning
probe a lane, the cache state's copy): ``serve.step``'s ``prefix`` phase,
from the tick's start event to the event that the admit graph records
after phase 1, over the profiler-free admit ticks, in the serving cells."""
from bench import program


def read(run):
    return program.mean(program.phase_ms(run, "prefix"))
