"""tick_host_ms: the mean host milliseconds of a profiler-free tick outside
its one sync: ``serve.step`` (staging, the graph's launch, the drain) less
its ``serve.fetch`` child, in the serving cells (``serve/engine.py``)."""
from bench import program


def read(run):
    return program.mean([s.ms - f.ms for s, f in
                         program.serve_ticks(run) or () if f is not None])
