"""CacheBackend layer: one API over the torch / CUDA-kernel / oracle paths.

Counterpart of ``repro/core/backend.py`` with the port's own registry:

    backend = make_backend("torch" | "cuda" | "ref", cfg, device=None)
    state = backend.init()
    state, hit, vals = backend.get(state, keys)
    state, ek, ev, slot_sets, slot_ways = backend.put(state, keys, vals)
    state, hit, vals, ek, ev = backend.access(state, keys, vals)
    vkeys, vvalid = backend.peek_victims(state, keys)
    hits, evs, state, sketch = backend.replay(state, chunks, enabled,
                                              tinylfu=None, sketch=None,
                                              hierarchy=None, ttls=None)

  * ``torch``: the tensor twin (``core/kway.py``) on any device;
  * ``cuda``: the hand-written kernels (kernels 1-4) feeding the same
    applies; for CPU tensors the kernels' plain versions run instead;
  * ``ref``: the sequential Python oracle (``core/refimpl.py``); it has no
    TinyLFU or hierarchical replay, as in the reference.

``device=None`` means the card ("cuda"); without one, ``make_backend``
raises unless the caller passes ``device="cpu"``.  Keys are uint32 (numpy
arrays or tensors); evicted and victim keys come back as int32 bit
patterns.  The reference's VMEM budgets have the port's own rules on
size: ``cuda`` replay runs kernel 3 where ``kernels.replay.resident_fits``
holds (at most ``MAX_BATCH`` lanes a chunk, its form's scratch within the
card's shared memory per block) and otherwise records a ``smem_budget``
event and runs the chunked path, as the reference falls back on
``vmem_budget``.  A hierarchy always runs kernel 4: both tiers live in
device memory, so the reference's ``hier_fits`` / ``l1_demotion`` have no
counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import admission, hashing, kway
from repro_torch.core import hierarchy as hier_mod
from repro_torch.core.hashing import EMPTY
from repro_torch.core.kway import KWayConfig, KWayState
from repro_torch.core.refimpl import RefKWay

_REGISTRY: dict[str, type] = {}

#: Shared memory per block, in bytes, that kernel 3's size rule
#: (``kernels/replay.py`` ``resident_fits``) holds a shape to in place of the
#: card's opt-in; None: the card's own.  Set only through ``smem_budget``.
SMEM_BUDGET = None


@contextlib.contextmanager
def smem_budget(nbytes: int):
    """Hold kernel 3 to ``nbytes`` of shared memory per block while open
    (restored in ``finally``): the counterpart of the reference's
    ``vmem_budget``.  It holds off the card too, where the plain versions
    use none, so a forced breach (``smem_budget(0)``) takes the chunked
    path on any device."""
    global SMEM_BUDGET
    prev = SMEM_BUDGET
    SMEM_BUDGET = nbytes
    try:
        yield
    finally:
        SMEM_BUDGET = prev


#: option pairs the reference refuses, refused with its words
HIER_TINYLFU = ("hierarchical replay does not support TinyLFU admission "
                "(the sketch has no per-tier semantics yet)")
REF_TINYLFU = "TinyLFU replay is not wired for the ref backend"
REF_HIER = ("hierarchical replay needs the 'torch' or 'cuda' backend; the "
            "ref oracle is flat-only")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    return dev


def register_backend(name: str):
    """Class decorator: register a CacheBackend implementation."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def make_backend(name: str, cfg: KWayConfig, device=None) -> "CacheBackend":
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown cache backend {name!r}; available: {available_backends()}")
    return _REGISTRY[name](cfg, resolve_device(device))


def _mask(x, device):
    return None if x is None else torch.as_tensor(x, dtype=torch.bool).to(device)


def _vals(x, device):
    """int32 values (payloads, TTLs) as a tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int32))
    return x.to(device=device, dtype=torch.int32)


class CacheBackend:
    """The backend contract.  Subclasses implement get/put/peek_victims;
    ``access`` (get; on miss, put) and ``replay`` are derived."""

    name = "?"
    #: tensor ops only, no host round trip: a CUDA graph can capture it
    #: (False: host Python)
    traceable = True

    def __init__(self, cfg: KWayConfig, device: torch.device):
        self.cfg = cfg
        self.device = device

    def init(self, *, ttl: bool = False) -> KWayState:
        return kway.make_cache(self.cfg, device=self.device, ttl=ttl)

    def keys(self, qkeys) -> torch.Tensor:
        """uint32 keys -> int32 key lanes on this backend's device."""
        return hashing.key_tensor(qkeys, self.device)

    # -- required ----------------------------------------------------------
    def get(self, state, qkeys, enabled=None):
        """-> (state', hit bool[B], vals int32[B])"""
        raise NotImplementedError

    def put(self, state, qkeys, qvals, admit=None, enabled=None, *,
            slot_value: bool = False):
        """-> (state', evicted_keys[B], evicted_valid[B], slot_sets[B],
        slot_ways[B]); slot_* == -1 where the key did not land."""
        raise NotImplementedError

    def peek_victims(self, state, qkeys):
        """-> (victim_keys int32[B], victim_valid bool[B]), no mutation."""
        raise NotImplementedError

    # -- derived -----------------------------------------------------------
    def access_two_phase(self, state, qkeys, qvals, admit_on_miss=None,
                         enabled=None, *, slot_value: bool = False):
        """The unfused get-then-put-on-miss composition: the oracle of the
        fused ``access``."""
        qvals = _vals(qvals, self.device)
        enabled = _mask(enabled, self.device)
        state, hit, vals = self.get(state, qkeys, enabled=enabled)
        en = (~hit) if enabled is None else (enabled & ~hit)
        state, ek, ev, ss, sw = self.put(
            state, qkeys, qvals, admit=admit_on_miss, enabled=en,
            slot_value=slot_value)
        return state, hit, _landed_vals(self.cfg, hit, vals, qvals, ss, sw,
                                        slot_value), ek, ev

    def access(self, state, qkeys, qvals, admit_on_miss=None, enabled=None,
               ttls=None, *, slot_value: bool = False):
        """-> (state', hit[B], vals[B], evicted_keys[B], evicted_valid[B]).
        The default is the two-phase composition, which has no expiry
        semantics."""
        if ttls is not None:
            raise ValueError(
                f"backend {self.name!r} access has no fused TTL path")
        return self.access_two_phase(state, qkeys, qvals,
                                     admit_on_miss=admit_on_miss,
                                     enabled=enabled, slot_value=slot_value)

    def replay(self, state, chunks, enabled, tinylfu=None, sketch=None,
               hierarchy=None, ttls=None):
        """Replay a chunked trace (``chunks`` uint32 [steps, B], ``enabled``
        bool [steps, B], optional ``ttls`` int32 [steps, B]; payload
        ``val == key``) -> (hits int32 [steps], evs int32 [steps], state',
        sketch' or None).

        ``tinylfu`` (a ``TinyLFUConfig``, with an optional ``sketch``;
        fresh when None) gates each miss by TinyLFU admission and returns
        the updated sketch.  ``hierarchy`` (a ``HierarchyConfig`` with
        ``l1_sets > 0``) replays through the L1-over-L2 hierarchy:
        ``state`` may be a ``HierState`` or a bare L2 ``KWayState`` (an
        empty L1 is attached), and a ``HierState`` comes back.

        Default: the chunked loop over ``access`` (with TinyLFU record ->
        peek -> admit -> access per chunk), the oracle of kernel 3; the
        hierarchy runs ``hierarchy.replay_l1_over_l2``, kernel 4's plain
        version."""
        _check_replay(tinylfu, ttls)
        if hierarchy is not None and hierarchy.enabled:
            return self._replay_hier(state, chunks, enabled, tinylfu,
                                     hierarchy, ttls)
        qkeys = self.keys(chunks)
        enabled = _mask(enabled, self.device)
        if tinylfu is not None:
            if sketch is None:
                sketch = admission.make_sketch(tinylfu, self.device)
            return admission.replay_chunks(tinylfu, sketch, self.access,
                                           self.peek_victims, state, qkeys,
                                           enabled)
        hits, evs, state = kway.replay_chunks(
            self.access, state, qkeys, enabled,
            None if ttls is None else _vals(ttls, self.device))
        return hits, evs, state, None

    def _replay_hier(self, state, chunks, enabled, tinylfu, hier, ttls):
        """The hierarchy through its plain version -> (hits, evs,
        HierState', None)."""
        if tinylfu is not None:
            raise ValueError(HIER_TINYLFU)
        hst = hier_mod.as_hier_state(self.cfg, hier, state)
        return hier_mod.replay_l1_over_l2(
            self.cfg, hier, hst, chunks, enabled,
            None if ttls is None else _vals(ttls, self.device))


def _landed_vals(cfg, hit, vals, qvals, ss, sw, slot_value):
    """The vals an access returns: the hit's stored value, else the request's
    value — or with ``slot_value`` the landing slot id (-1: did not land)."""
    if not slot_value:
        return torch.where(hit, vals, qvals)
    slot_id = (ss * cfg.ways + sw).to(torch.int32)
    return torch.where(hit, vals, torch.where(
        ss >= 0, slot_id, torch.full_like(slot_id, -1)))


def _check_replay(tinylfu, ttls):
    if ttls is not None and tinylfu is not None:
        raise ValueError(admission.TTL_EXCLUSIVE)


@register_backend("torch")
class TorchBackend(CacheBackend):
    """The tensor twin (core/kway.py) on any device."""

    def get(self, state, qkeys, enabled=None):
        return kway.get(self.cfg, state, self.keys(qkeys),
                        enabled=_mask(enabled, self.device))

    def put(self, state, qkeys, qvals, admit=None, enabled=None, *,
            slot_value: bool = False):
        return kway.put(self.cfg, state, self.keys(qkeys),
                        _vals(qvals, self.device),
                        admit=_mask(admit, self.device),
                        enabled=_mask(enabled, self.device),
                        slot_value=slot_value)

    def access(self, state, qkeys, qvals, admit_on_miss=None, enabled=None,
               ttls=None, *, slot_value: bool = False):
        return kway.access(self.cfg, state, self.keys(qkeys),
                           _vals(qvals, self.device),
                           _mask(admit_on_miss, self.device),
                           _mask(enabled, self.device),
                           None if ttls is None else
                           _vals(ttls, self.device),
                           slot_value=slot_value)

    def peek_victims(self, state, qkeys):
        return kway.peek_victims(self.cfg, state, self.keys(qkeys))


@register_backend("cuda")
class CudaBackend(CacheBackend):
    """The hand-written kernels + the shared torch applies: ``get`` runs
    kernel 1 without victims, ``put`` kernel 1 with the full order,
    ``peek_victims`` kernel 1 with the victim, ``access`` kernel 2 and
    ``replay`` kernel 3.  Bit-identical to ``torch`` at any batch size."""

    def __init__(self, cfg: KWayConfig, device: torch.device):
        from repro_torch.kernels import kway_probe as _kp
        if cfg.sample:
            raise ValueError("cuda backend does not support sampled policies "
                             "(cfg.sample > 0); use the torch backend")
        if cfg.ways > _kp.MAX_WAYS:
            raise ValueError(f"cuda backend requires ways <= {_kp.MAX_WAYS}; "
                             f"got {cfg.ways}")
        super().__init__(cfg, device)

    def get(self, state, qkeys, enabled=None):
        from repro_torch.kernels import ops
        _, sets, hit, way = ops.probe_hits(self.cfg, state, self.keys(qkeys))
        if enabled is not None:
            hit = hit & _mask(enabled, self.device)
        return kway.apply_get(self.cfg, state, sets, hit, way)

    def put(self, state, qkeys, qvals, admit=None, enabled=None, *,
            slot_value: bool = False):
        from repro_torch.kernels import ops
        qk, sets, present, way_present, order = ops.probe_orders(
            self.cfg, state, self.keys(qkeys))
        return kway.apply_put(
            self.cfg, state, qk, _vals(qvals, self.device), sets, present,
            way_present, order, _mask(admit, self.device),
            _mask(enabled, self.device), slot_value=slot_value)

    def access(self, state, qkeys, qvals, admit_on_miss=None, enabled=None,
               ttls=None, *, slot_value: bool = False):
        from repro_torch.kernels import ops
        qkeys = self.keys(qkeys)
        enabled = _mask(enabled, self.device)
        if state.expiry is not None:
            state = kway.scrub_expired(state, state.clock + 2 * qkeys.shape[0])
        qk, sets, hit_raw, way, order = ops.fused_probe(
            self.cfg, state, qkeys, enabled)
        return kway.apply_access(
            self.cfg, state, qk, _vals(qvals, self.device), sets, hit_raw,
            way, _mask(admit_on_miss, self.device), enabled, order=order,
            ttls=None if ttls is None else _vals(ttls, self.device),
            slot_value=slot_value)

    def peek_victims(self, state, qkeys):
        from repro_torch.kernels import ops
        _, _, hit, _, _, vkey = ops.probe(self.cfg, state, self.keys(qkeys))
        return vkey, (vkey != EMPTY) & (~hit)

    def replay_scan(self, state, chunks, enabled, tinylfu=None, sketch=None,
                    ttls=None):
        """The chunked loop over this backend's ``access`` (kernel 2 + the
        torch apply; with TinyLFU, kernel 1 peeks the victims): kernel 3's
        second oracle."""
        return CacheBackend.replay(self, state, chunks, enabled,
                                   tinylfu=tinylfu, sketch=sketch, ttls=ttls)

    def replay(self, state, chunks, enabled, tinylfu=None, sketch=None,
               hierarchy=None, ttls=None):
        """Kernel 4 for a hierarchy, else kernel 3 (with TinyLFU's branch
        when ``tinylfu``), one launch for the whole trace; where kernel 3
        does not take the shape (``resident_fits``), one ``smem_budget``
        event and the chunked path."""
        from repro_torch.kernels import ops
        from repro_torch.kernels import replay as krp
        _check_replay(tinylfu, ttls)
        if hierarchy is not None and hierarchy.enabled:
            if tinylfu is not None:
                raise ValueError(HIER_TINYLFU)
            hst = hier_mod.as_hier_state(self.cfg, hierarchy, state,
                                         ttl=ttls is not None)
            return ops.replay_hierarchical(self.cfg, hierarchy, hst, chunks,
                                           enabled, ttls=ttls)
        batch = chunks.shape[1]
        if not krp.resident_fits(self.cfg, batch, tinylfu is not None,
                                 self.device):
            from repro_torch.robust import events
            need = krp.resident_smem_bytes(self.cfg, batch,
                                           tinylfu is not None)
            events.record(
                component="cuda.replay", reason="smem_budget",
                fallback_from="cuda-resident", fallback_to="cuda-scan",
                detail=(f"kernel 3 needs {need} B of shared memory per "
                        f"block (limit {krp.smem_limit(self.device)}) "
                        f"and takes at most {krp.MAX_BATCH} lanes a chunk "
                        f"(num_sets={self.cfg.num_sets}, ways="
                        f"{self.cfg.ways}, batch={batch}); falling back "
                        f"to the chunked path"))
            return self.replay_scan(state, chunks, enabled, tinylfu=tinylfu,
                                    sketch=sketch, ttls=ttls)
        return ops.replay_resident(self.cfg, state, chunks, enabled,
                                   ttls=ttls, tinylfu=tinylfu, sketch=sketch)


@register_backend("ref")
class RefBackend(CacheBackend):
    """Sequential Python oracle behind the same functional API: each call
    imports the state into a ``RefKWay``, replays the batch one lane at a
    time (a disabled lane still consumes a timestamp) and exports back.
    Bit-identical to the others at batch size 1."""

    traceable = False

    def replay(self, state, chunks, enabled, tinylfu=None, sketch=None,
               hierarchy=None, ttls=None):
        """The chunked loop over the oracle's ``access``; TinyLFU and the
        hierarchy are refused, as the reference refuses them."""
        if tinylfu is not None:
            raise ValueError(REF_TINYLFU)
        if hierarchy is not None and hierarchy.enabled:
            raise ValueError(REF_HIER)
        return super().replay(state, chunks, enabled, ttls=ttls)

    def _import(self, state: KWayState) -> RefKWay:
        cfg = self.cfg
        ref = RefKWay(cfg.num_sets, cfg.ways, cfg.policy, cfg.seed)
        keys = state.keys.cpu().numpy().view(np.uint32)
        vals = state.vals.cpu().numpy()
        ma = state.meta_a.cpu().numpy()
        mb = state.meta_b.cpu().numpy()
        exp = None if state.expiry is None else state.expiry.cpu().numpy()
        for s, w in zip(*np.nonzero(keys != hashing.EMPTY_KEY)):
            node = {"key": int(keys[s, w]), "val": int(vals[s, w]),
                    "a": int(ma[s, w]), "b": int(mb[s, w])}
            if exp is not None:
                node["exp"] = int(exp[s, w])
            ref.sets[s][w] = node
        ref.clock = int(state.clock)
        ref.expiry_enabled = exp is not None
        return ref

    def _export(self, ref: RefKWay) -> KWayState:
        cfg = self.cfg
        shape = (cfg.num_sets, cfg.ways)
        keys = np.full(shape, hashing.EMPTY_KEY, np.uint32)
        vals = np.zeros(shape, np.int32)
        ma = np.zeros(shape, np.int32)
        mb = np.zeros(shape, np.int32)
        exp = np.full(shape, kway.NO_EXPIRY, np.int32) \
            if ref.expiry_enabled else None
        for s in range(cfg.num_sets):
            for w, node in enumerate(ref.sets[s]):
                if node is not None:
                    keys[s, w] = node["key"]
                    vals[s, w] = node["val"]
                    ma[s, w] = node["a"]
                    mb[s, w] = node["b"]
                    if exp is not None:
                        exp[s, w] = node.get("exp", kway.NO_EXPIRY)
        keys_t = hashing.key_tensor(keys, self.device)
        fpr = torch.where(keys_t == EMPTY, torch.zeros_like(keys_t),
                          hashing.fingerprint(keys_t))
        dev = self.device
        return KWayState(
            keys=keys_t, fprint=fpr, vals=torch.from_numpy(vals).to(dev),
            meta_a=torch.from_numpy(ma).to(dev),
            meta_b=torch.from_numpy(mb).to(dev),
            clock=torch.tensor(ref.clock, dtype=torch.int32, device=dev),
            expiry=None if exp is None else torch.from_numpy(exp).to(dev))

    def _lanes(self, qkeys, enabled):
        ks = [int(k) for k in self.keys(qkeys).cpu().numpy().view(np.uint32)]
        ks = [0xFFFFFFFE if k == 0xFFFFFFFF else k for k in ks]  # sanitize
        en = (np.ones(len(ks), bool) if enabled is None
              else torch.as_tensor(enabled).cpu().numpy().astype(bool))
        return ks, en

    def _out(self, arr, dtype=None):
        return torch.as_tensor(arr, dtype=dtype).to(self.device)

    def get(self, state, qkeys, enabled=None):
        ref = self._import(state)
        ks, en = self._lanes(qkeys, enabled)
        hit = np.zeros(len(ks), bool)
        vals = np.full(len(ks), -1, np.int32)
        for i, k in enumerate(ks):
            if not en[i]:
                ref.clock += 1  # a disabled lane still consumes a timestamp
                continue
            v = ref.get(k)
            if v is not None:
                hit[i], vals[i] = True, v
        return self._export(ref), self._out(hit), self._out(vals)

    def put(self, state, qkeys, qvals, admit=None, enabled=None, *,
            slot_value: bool = False):
        ref = self._import(state)
        ks, en = self._lanes(qkeys, enabled)
        vs = _vals(qvals, "cpu").numpy()
        ad = (np.ones(len(ks), bool) if admit is None
              else torch.as_tensor(admit).cpu().numpy().astype(bool))
        b = len(ks)
        ek = np.zeros(b, np.uint32)
        ev = np.zeros(b, bool)
        slot_sets = np.full(b, -1, np.int64)
        slot_ways = np.full(b, -1, np.int64)
        for i, k in enumerate(ks):
            if not en[i]:
                ref.clock += 1
                continue
            evicted, s, w = ref.put(k, int(vs[i]), admit=bool(ad[i]))
            if w is not None:
                slot_sets[i], slot_ways[i] = s, w
                if slot_value:
                    ref.sets[s][w]["val"] = s * self.cfg.ways + w
                if ref.expiry_enabled:
                    # a bare put has no TTL: the landing lane never expires
                    ref.sets[s][w]["exp"] = kway.NO_EXPIRY
            if evicted is not None:
                ek[i], ev[i] = evicted, True
        return (self._export(ref), self._out(ek.view(np.int32)),
                self._out(ev), self._out(slot_sets), self._out(slot_ways))

    def peek_victims(self, state, qkeys):
        ref = self._import(state)
        ks, _ = self._lanes(qkeys, None)
        clock0 = ref.clock
        vk = np.zeros(len(ks), np.uint32)
        vv = np.zeros(len(ks), bool)
        for i, k in enumerate(ks):
            ref.clock = clock0 + i   # lane i probes at logical time clock+i
            victim = ref.peek_victim(k)
            if victim is not None:
                vk[i], vv[i] = victim, True
        return self._out(vk.view(np.int32)), self._out(vv)

    def access(self, state, qkeys, qvals, admit_on_miss=None, enabled=None,
               ttls=None, *, slot_value: bool = False):
        """Oracle access with the batched paths' expiry discipline: scrub at
        the batch-exit clock before probing, two-phase get/put, then stamp
        landed lanes with ``clock0 + 2B + ttl`` (``ttl <= 0``: never)."""
        b = len(np.atleast_1d(np.asarray(
            qkeys.cpu() if isinstance(qkeys, torch.Tensor) else qkeys)))
        if state.expiry is not None:
            state = kway.scrub_expired(state, state.clock + 2 * b)
        if ttls is None:
            return self.access_two_phase(
                state, qkeys, qvals, admit_on_miss=admit_on_miss,
                enabled=enabled, slot_value=slot_value)
        if state.expiry is None:
            raise ValueError(
                "ref access: ttls given but the state has no expiry lane — "
                "build it with init(ttl=True) or kway.ensure_expiry()")
        clock0 = int(state.clock)
        qvals = _vals(qvals, self.device)
        enabled = _mask(enabled, self.device)
        state, hit, vals = self.get(state, qkeys, enabled=enabled)
        en = (~hit) if enabled is None else (enabled & ~hit)
        state, ek, ev, ss, sw = self.put(state, qkeys, qvals,
                                         admit=admit_on_miss, enabled=en,
                                         slot_value=slot_value)
        tt = _vals(ttls, "cpu").numpy()
        exp = state.expiry.cpu().numpy().copy()
        ssn, swn = ss.cpu().numpy(), sw.cpu().numpy()
        for i in range(b):
            if ssn[i] >= 0:
                exp[ssn[i], swn[i]] = (clock0 + 2 * b + int(tt[i])
                                       if tt[i] > 0 else kway.NO_EXPIRY)
        state = dataclasses.replace(
            state, expiry=torch.from_numpy(exp).to(self.device))
        return state, hit, _landed_vals(self.cfg, hit, vals, qvals, ss, sw,
                                        slot_value), ek, ev
