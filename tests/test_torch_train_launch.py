"""The port's training launcher (``repro_torch.launch.train``) and the
checkpoint of a model and its optimizer state, on the CPU.

Counterpart of ``tests/test_ckpt_data.py::test_train_driver_resume``:
mamba2-130m smoke trains 6 steps with ``--device cpu``, then resumes to 10;
``latest_step`` reads 6, then 10, and the resumed losses are bit-equal to
an uninterrupted 10-step run.  The learning-rate schedule's length is
``--steps`` (as in the reference), so a run cut at 6 by ``--steps 6`` and
a 10-step run share their schedule only under ``--schedule const``; the
default cosine schedule is held to the same bar by a run cut at step 4 by
SIGTERM.  Faults: a step that fails twice is retried, a third failure
checkpoints and re-raises, SIGTERM checkpoints and returns 0.  The
checkpoint of ``{"params": model, "opt": state}`` round-trips bf16
parameters and the int32 step bit for bit.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.ckpt import manager as ckpt
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

SMOKE = ["--arch", "mamba2-130m", "--smoke", "--batch", "2", "--seq", "32",
         "--device", "cpu"]


def _run(*extra):
    return train.run(train.parse(SMOKE + list(extra)))


def _with_faulty_step(monkeypatch, on_call):
    """Wrap the launcher's train step: ``on_call(n)`` runs before the n-th
    call (from 1) and may raise or signal."""
    real = tstep.make_train_step
    calls = {"n": 0}

    def factory(cfg, tcfg):
        step = real(cfg, tcfg)

        def wrapped(*a):
            calls["n"] += 1
            on_call(calls["n"])
            return step(*a)

        return wrapped

    monkeypatch.setattr(train, "make_train_step", factory)
    return calls


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    d = str(tmp_path / "run")
    first = _run("--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3",
                 "--schedule", "const")
    assert ckpt.latest_step(d) == 6 and first.data_step == 6
    assert sorted(os.listdir(d)) == ["step_000000003", "step_000000006"]
    rest = _run("--steps", "10", "--ckpt-dir", d, "--ckpt-every", "3",
                "--schedule", "const")
    assert rest.start_step == 6 and rest.data_step == 10
    assert ckpt.latest_step(d) == 10
    whole = _run("--steps", "10", "--schedule", "const")
    assert len(whole.losses) == 10 and rest.ended == whole.ended == "done"
    assert first.losses + rest.losses == whole.losses
    for a, b in zip(rest.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)
    assert int(rest.opt_state["step"]) == int(whole.opt_state["step"]) == 10
    # a finished run resumes to nothing and saves its last step again
    again = _run("--steps", "10", "--ckpt-dir", d, "--schedule", "const")
    assert again.start_step == 10 and again.losses == []


def test_sigterm_checkpoints_and_returns_zero(tmp_path, monkeypatch):
    """SIGTERM in step 4 (cosine schedule): the step finishes, step 4 is
    checkpointed with its data cursor, ``main`` returns 0, the handler is
    put back; the resumed run equals an uninterrupted one bit for bit."""
    d = str(tmp_path / "run")
    prev = signal.getsignal(signal.SIGTERM)
    calls = _with_faulty_step(monkeypatch, lambda n: n == 4 and os.kill(
        os.getpid(), signal.SIGTERM))
    assert train.main(SMOKE + ["--steps", "10", "--ckpt-dir", d]) == 0
    assert calls["n"] == 4 and ckpt.latest_step(d) == 4
    assert signal.getsignal(signal.SIGTERM) is prev
    with open(os.path.join(d, "step_000000004", "manifest.json")) as f:
        assert json.load(f)["extra"] == {"step": 4, "data_step": 4}
    monkeypatch.undo()
    rest = _run("--steps", "10", "--ckpt-dir", d)
    whole = _run("--steps", "10")
    assert rest.start_step == 4 and rest.ended == "done"
    assert rest.losses == whole.losses[4:]


def test_step_retried_after_two_failures(monkeypatch):
    def fail(n):
        if n in (3, 4):
            raise RuntimeError(f"transient fault {n}")

    calls = _with_faulty_step(monkeypatch, fail)
    got = _run("--steps", "6")
    assert calls["n"] == 8 and len(got.losses) == 6
    monkeypatch.undo()
    assert got.losses == _run("--steps", "6").losses


def test_third_failure_checkpoints_and_reraises(tmp_path, monkeypatch):
    d = str(tmp_path / "run")

    def fail(n):
        if n >= 3:
            raise RuntimeError("chip lost")

    calls = _with_faulty_step(monkeypatch, fail)
    with pytest.raises(RuntimeError, match="chip lost"):
        _run("--steps", "6", "--ckpt-dir", d, "--ckpt-every", "100")
    assert calls["n"] == 5                        # steps 1, 2, then 3 x3
    assert ckpt.latest_step(d) == 2
    monkeypatch.undo()
    rest = _run("--steps", "6", "--ckpt-dir", d)
    assert rest.start_step == 2 and rest.data_step == 6
    assert rest.losses == _run("--steps", "6").losses[2:]


def test_mesh_flags_and_device_default():
    """--data / --model above 1 need a process group of that many ranks
    (torchrun); without one the launcher says so."""
    with pytest.raises(ValueError, match="needs a process group"):
        _run("--steps", "1", "--data", "2")
    with pytest.raises(ValueError, match="needs a process group"):
        _run("--steps", "1", "--model", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_frontend_stubs(arch):
    """The per-arch batch stubs: a VLM's zero patch embeddings with the
    tokens cut to make room, an encoder-decoder's zero frames for the
    second half; two steps train with finite losses."""
    cfg = configs.get(arch).smoke
    args = train.parse(["--arch", arch, "--smoke", "--batch", "2", "--seq",
                        "32", "--steps", "2", "--device", "cpu"])
    toks = np.arange(64, dtype=np.int32).reshape(2, 32)
    batch = train.make_batch(cfg, args, toks, toks + 1, "cpu")
    if cfg.frontend == "patch":
        assert batch["tokens"].shape == (2, 32 - cfg.frontend_len)
        assert batch["prefix_embeds"].shape == (2, cfg.frontend_len,
                                                cfg.d_model)
        assert batch["labels"].shape == (2, 32)
    else:
        assert batch["tokens"].shape == batch["labels"].shape == (2, 16)
        assert batch["enc_embeds"].shape == (2, 16, cfg.d_model)
    got = train.run(args)
    assert len(got.losses) == 2 and np.all(np.isfinite(got.losses))


def test_checkpoint_round_trips_model_and_state(tmp_path):
    """``{"params": model, "opt": state}``: stable parameter names, bf16
    parameters and float32 state bit for bit, the int32 step, restored in
    place into parameters that require grad."""
    cfg = configs.get("gemma2-2b").smoke
    model = lm.init_params(cfg, seed=1, device="cpu")
    model.requires_grad_(True)
    state = adamw.init(model)
    g = torch.Generator().manual_seed(2)
    for k in ("m", "v"):
        for t in state[k].values():
            t.copy_(torch.randn(t.shape, generator=g))
    state["step"].fill_(7)
    paths = [p for p, _ in ckpt.flatten({"params": model, "opt": state})]
    assert "['params'].blocks.1.attn.wq" in paths
    assert "['opt']['step']" in paths
    ckpt.save(str(tmp_path), 7, {"params": model, "opt": state},
              extra={"step": 7, "data_step": 7})
    other = lm.init_params(cfg, seed=9, device="cpu")
    other.requires_grad_(True)
    ptrs = [p.data_ptr() for p in other.parameters()]
    ostate = adamw.init(other)
    tree, extra = ckpt.restore(str(tmp_path), 7, {"params": other,
                                                  "opt": ostate})
    assert extra == {"step": 7, "data_step": 7}
    assert tree["params"] is other
    assert [p.data_ptr() for p in other.parameters()] == ptrs
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    assert any(p.dtype == torch.bfloat16 for p in other.parameters())
    assert ostate["step"].dtype == torch.int32 and int(ostate["step"]) == 7
    for k in ("master", "m", "v"):
        for n in state[k]:
            assert torch.equal(ostate[k][n], state[k][n]), (k, n)
    wrong = lm.init_params(configs.get("deepseek-7b").smoke, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore(str(tmp_path), 7, {"params": wrong,
                                        "opt": adamw.init(wrong)})
