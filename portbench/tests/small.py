"""Small sizes of every cell, for the CPU tests: the same drivers, keys
and shapes of configuration and traffic, at a size the CPU runs in
seconds."""
import copy

KWAY = {"name": "kway-small", "num_sets": 64, "ways": 8, "policy": "LRU",
        "backend": "cuda"}

DENSE = {"name": "deepseek-smoke", "hidden_size": 64,
         "intermediate_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 4, "num_hidden_layers": 2,
         "vocab_size": 512, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
         "tie_word_embeddings": False,
         "engine": {"page": 16, "num_sets": 8, "ways": 8, "max_batch": 4,
                    "max_seq": 256, "max_prompt": 128, "private_pages": 64,
                    "decode_block": 2, "policy": "LRU", "backend": "cuda"}}

KEYS = {"law": "zipf", "alpha": 0.99, "catalog": 4096, "scramble_seed": 1}

TRAFFIC = {
    "replay-ycsbc": {"drive": "replay", "keys": KEYS, "traces": 2,
                     "requests": 2048, "batch": 64},
    "serve-sessions": {"drive": "serve", "clients": 4, "system_tokens": 32,
                       "sessions": 4, "session_zipf": 0.99,
                       "doc_tokens": 32, "tail_tokens": [8, 48],
                       "max_new": [4, 8], "prime_max_new": 1,
                       "check_requests": 3, "sizes_seed": 1},
}

#: a serving mix without sessions (no priming): the driver's other path
FRESH = {"drive": "serve", "clients": 4, "system_tokens": 0, "sessions": 0,
         "doc_tokens": 0, "tail_tokens": [72, 112], "max_new": [4, 8],
         "check_requests": 3, "sizes_seed": 1}


def config(workload: str) -> dict:
    return copy.deepcopy(KWAY if TRAFFIC[workload]["drive"] != "serve"
                         else DENSE)


def traffic(workload: str) -> dict:
    return copy.deepcopy(TRAFFIC[workload])


def seconds(workload: str) -> float:
    """A window long enough for the small cell to finish requests on a
    busy CPU."""
    return 3.0 if TRAFFIC[workload]["drive"] == "serve" else 0.5


class FakeClock:
    """Stands in for the serving driver's ``time``: the clock advances a
    fixed step at every reading, so a window runs the same number of ticks
    on any CPU, however busy."""

    def __init__(self, step: float = 0.01):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def steady_clock(monkeypatch, workload: str) -> None:
    if TRAFFIC[workload]["drive"] == "serve":
        import bench.drive_serve
        monkeypatch.setattr(bench.drive_serve, "time", FakeClock())
