"""Roofline analysis of a dry-run step on NVIDIA H100 constants (no
hardware needed).

Counterpart of ``repro/roofline/analysis.py``.  Three terms per (arch x
shape x mesh), in seconds:

    compute    = FLOPs            / (chips x peak_FLOPs)
    memory     = bytes            / (chips x HBM_bw)
    collective = collective_bytes / (chips x link_bw)

Hardware model: one H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s HBM,
450 GB/s of NVLink 4 per GPU in one direction.  A 16x16 mesh spans nodes
of 8 GPUs, between which InfiniBand gives about 50 GB/s per GPU; the one
link constant for every collective is the reference's model, kept as it
is.

Sources.  The reference reads XLA's ``cost_analysis`` of a compiled step
and scrapes collectives from its post-SPMD HLO (``_shape_bytes`` and
``collective_bytes_per_device``, kept here with its tests).  The port
runs its step eagerly, on DTensors, under ``FakeTensorMode`` or for real,
and counts with ``StepCounter``, a dispatch mode under DTensor (it lets
DTensor lower each op into the local ops and collectives of one rank,
then sees those):

  * FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    registry) on each rank's local shards: a count **per device**, which
    ``dryrun`` multiplies by ``chips`` as the reference multiplies its
    per-device costs (a replicated op counts on every device);
  * bytes: each local op's tensor inputs read once and outputs written
    once (views move nothing): the eager step's own traffic, op by op.
    The reference's XLA count is after fusion, so it is smaller for the
    same step;
  * collectives: the result bytes per device of each ``_c10d_functional``
    op DTensor issues, by the reference's kind names.  On a ``"cpu"``
    mesh DTensor lowers an all-to-all into an all-gather and a chunk
    (gloo has none), so a cell's breakdown depends on the mesh's device
    type, which its record names;
  * live bytes: every storage a local op creates, from its creation until
    it is freed; ``peak_new`` is the most alive at once (the step's
    temporaries and outputs beyond what existed before it).

Ops that DTensor runs only to infer a result's shape (on fake tensors of
the global shapes) are not counted.  Eager torch has no scan whose
body is counted once, so the full depth is counted directly: the
reference's p / 2p-layer extrapolation (``extrapolate``) is kept for its
tests and is not needed by the port's dry run.
"""
from __future__ import annotations

import dataclasses
import re
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# --- hardware constants (NVIDIA H100 SXM) ---
PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 450e9              # bytes/s per GPU, NVLink 4, one direction

_COLLECTIVE_RE = re.compile(
    r"=\s*((?:\([^)]*\)|\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

#: ``_c10d_functional`` op -> the reference's collective kind (another
#: collective counts under its own name; ``wait_tensor`` moves nothing)
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes_per_device(hlo_text: str) -> dict:
    """Sum result bytes of collective ops in a (post-SPMD) HLO module.

    Returns {op_kind: bytes} per device.
    """
    out: dict = {}
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        out[kind] = out.get(kind, 0) + _shape_bytes(shape_str)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts one rank's work over a block of eager torch code: ``flops``,
    ``bytes``, ``collectives`` ({kind: result bytes}), ``live`` /
    ``peak_new`` (bytes of storages created inside the block and alive /
    most alive at once) and ``ops``.  Enter it inside ``FakeTensorMode``
    for a dry run, or around a real step: it counts the same either way.
    While it is entered it wraps DTensor's shape inference, so the ops run
    there are not counted."""

    def __init__(self, trace_bytes: int | None = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = {}
        self.ops = 0
        self.live = 0
        self.peak_new = 0
        self._refs: dict = {}
        self._inferring = 0
        #: with ``trace_bytes``: the storages of at least that many bytes
        #: alive at the peak, as (bytes, op, the port's source line that
        #: ran it), largest first
        self.trace_bytes = trace_bytes
        self.peak_storages: list = []
        self._made: dict = {}

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        # DTensor infers each result's global shape by running the op on
        # fake tensors of the global shapes: not work of any rank
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        self._saved_prop = prop

        def inferring(propagator, *a, **kw):
            self._inferring += 1
            try:
                return prop(propagator, *a, **kw)
            finally:
                self._inferring -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = inferring
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = \
            self._saved_prop
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor, op: str = ""):
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self.live += n

        def freed(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)
            self._made.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        if self.trace_bytes is not None and n >= self.trace_bytes:
            self._made[key] = (n, op, _port_line())
        if self.live > self.peak_new:
            self.peak_new = self.live
            if self.trace_bytes is not None:
                self.peak_storages = sorted(self._made.values(),
                                            reverse=True)

    def known(self, tensors):
        """Mark storages that exist before the step (its arguments), so an
        in-place op on them creates nothing."""
        from torch.distributed.tensor import DTensor

        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            st = t.untyped_storage()
            self._refs.setdefault(id(st), weakref.ref(st))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor lower it, then count
        out = func(*args, **kwargs)
        if self._inferring:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        ns = getattr(func, "namespace", "")
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional":
            if name != "wait_tensor":
                kind = COLLECTIVE_KINDS.get(name, name)
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + sum(map(_nbytes, outs)))
            return out
        if ns == "prim" or func.is_view:
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for o in outs:
            self._track(o, name)
        return out

    def to_json(self) -> dict:
        out = {"flops": self.flops, "bytes": self.bytes,
               "collectives": dict(self.collectives), "ops": self.ops,
               "peak_new_bytes": self.peak_new}
        if self.trace_bytes is not None:
            out["peak_storages"] = [list(x) for x in self.peak_storages]
        return out


def _port_line() -> str:
    """``file:line`` of the innermost frame of the port's own code (this
    module and torch excluded)."""
    import traceback

    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace("\\", "/")
        if "repro_torch/" in path and not path.endswith(
                "roofline/analysis.py"):
            return f"{path[path.rindex('repro_torch/'):]}:{fr.lineno}"
    return "?"


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # global: per-device count x chips
    hlo_bytes: float             # global bytes the eager ops move
    coll_bytes: float            # global collective bytes
    coll_breakdown: dict
    model_flops: float           # analytic 6·N·D (active params for MoE)
    per_device_peak_memory: float  # arguments + temp + outputs

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPs/s achieved at the roofline step time vs peak — the
        MFU the step could reach if perfectly overlapped."""
        if self.step_time == 0:
            return 0.0
        return self.model_flops / (self.step_time * self.chips * PEAK_FLOPS)

    def to_json(self) -> dict:
        return {
            **{f.name: getattr(self, f.name) for f in dataclasses.fields(self)},
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "step_time": self.step_time,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def extrapolate(c_p: float, c_2p: float, num_periods: int) -> float:
    """total(L) = c(p) + (L/p - 1) · (c(2p) - c(p));  num_periods = L/p."""
    per_period = c_2p - c_p
    return c_p + (num_periods - 1) * per_period


def extrapolate_dict(d_p: dict, d_2p: dict, num_periods: int) -> dict:
    keys = set(d_p) | set(d_2p)
    return {
        k: extrapolate(d_p.get(k, 0), d_2p.get(k, 0), num_periods) for k in keys
    }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for one step of this cell.

    train: 6·N·D (fwd+bwd, D = tokens/step).   prefill: 2·N·D.
    decode: 2·N·B (one token per sequence) — attention-over-cache flops are
    excluded by convention (they are in the counted FLOPs instead).
    """
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch
