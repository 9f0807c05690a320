"""prefill_useful_share: of the prompt tokens the admit ticks prefilled
(every lane padded to ``max_prompt``: the ``serve.prefill_tokens_padded``
counter), the share a request needed (its prompt after its prefix hits:
``serve.prefill_tokens_needed``), over the window, in the serving cells
(counted on the host in ``serve/engine.py``'s drain)."""
from bench import program


def read(run):
    c = program.counters()
    padded = c.get("serve.prefill_tokens_padded")
    if not padded:
        return None
    return 100.0 * c.get("serve.prefill_tokens_needed", 0) / padded
