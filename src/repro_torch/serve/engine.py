"""Continuous-batching serving engine of the port — counterpart of
``repro/serve/engine.py``.

One :class:`Engine` owns a fixed-shape decode batch of ``max_batch``
slots over a :class:`~repro_torch.serve.kv_cache.PagedDecodeCache`.  Every
tick it (1) retires finished sequences and frees their pages, (2) admits
queued prompts into free slots — at most ``max_prefill_per_tick`` per
tick — and (3) runs ONE decode step at the fixed ``(max_batch, 1)`` shape
with active-slot masking and per-row positions.  PyTorch runs eagerly, so
there are no compiled programs to build or count.

At temperature 0 the per-row outputs match the static
``launch/serve.generate`` reference with the same ``max_len`` as long as
the per-row arithmetic does not depend on the batch size: the
vector-position decode writes the same cache values and garbage
rows/pages only ever contribute exp(NEG_INF) = 0.0 to the softmax.  On the
CPU, PyTorch's matrix products give the same rows for every batch of two
or more rows but take another path for a single row, so the CPU tests
hold the contract against ``generate`` at a batch of at least two.  int8
KV quantization is lossy by construction.

Timing is injectable: the default :class:`Clock` reads the wall (each
tick ends in a device-to-host copy of the sampled tokens, so the clock
sees finished device work); :class:`SimClock` + :class:`SimCosts` run the
SAME scheduling logic on modeled per-step costs with no device work.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import tensor_device
from repro_torch.serve.kv_cache import PagedDecodeCache


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------

class Clock:
    """Wall clock with an idle fast-forward: ``skip_to`` advances a virtual
    offset instead of sleeping, so a trace with gaps replays without
    penalizing the server for having no work."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._offset = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._offset

    def skip_to(self, t: float) -> None:
        self._offset += max(0.0, t - self.now())

    def advance(self, dt: float) -> None:   # no-op: real work takes real time
        del dt


class SimClock:
    """Virtual clock for deterministic simulation: work advances it by
    modeled costs (:class:`SimCosts`), idleness skips it forward."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def skip_to(self, t: float) -> None:
        self.t = max(self.t, t)

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass(frozen=True)
class SimCosts:
    """Modeled per-step costs for simulated serving: a prefill charges
    ``tokens x prefill_s_per_token``; every decode tick charges the flat
    ``decode_step_s`` of the fixed-shape step."""
    prefill_s_per_token: float = 2e-4
    decode_step_s: float = 2e-3


# ---------------------------------------------------------------------------
# Requests / completions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int                  # generated tokens incl. the prefill token
    arrival_s: float = 0.0
    temperature: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray            # (n,) int32 generated tokens
    arrival_s: float
    admit_s: float
    emit_s: List[float]           # per-token emission times

    @property
    def first_token_s(self) -> float:
        """First emission, or the admit time for a zero-token completion."""
        return self.emit_s[0] if self.emit_s else self.admit_s

    @property
    def finish_s(self) -> float:
        return self.emit_s[-1] if self.emit_s else self.admit_s

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def per_token_latency_s(self) -> float:
        """Normalized request latency: (finish - arrival) / generated
        tokens."""
        return (self.finish_s - self.arrival_s) / max(len(self.tokens), 1)


def poisson_trace(n: int, mean_interarrival_s: float, prompt_len: int,
                  max_new_choices: Sequence[int], vocab: int,
                  seed: int = 0) -> List[Request]:
    """A deterministic Poisson arrival trace: exponential interarrivals,
    random prompts, and generation lengths drawn from
    ``max_new_choices`` (numpy-drawn: the same trace as the reference's)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.exponential(mean_interarrival_s))
        out.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab, size=(prompt_len,)).astype(np.int32),
            max_new=int(rng.choice(np.asarray(max_new_choices))),
            arrival_s=t))
    return out


def latency_summary(completions: Sequence[Completion]) -> Dict[str, float]:
    """Throughput + per-token latency percentiles over a finished trace."""
    if not completions:
        return {"tokens": 0, "tokens_per_s": 0.0, "makespan_s": 0.0,
                "p50_s": 0.0, "p99_s": 0.0, "mean_ttft_s": 0.0}
    toks = sum(len(c.tokens) for c in completions)
    t0 = min(c.arrival_s for c in completions)
    t1 = max(c.finish_s for c in completions)
    lat = np.asarray([c.per_token_latency_s for c in completions])
    return {"tokens": toks,
            "tokens_per_s": toks / max(t1 - t0, 1e-12),
            "makespan_s": t1 - t0,
            "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "mean_ttft_s": float(np.mean([c.ttft_s for c in completions]))}


def sample_token(row_logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> int:
    """Greedy at temperature <= 0, else a draw from softmax(logits / T)."""
    if temperature <= 0.0:
        return int(torch.argmax(row_logits))
    probs = torch.softmax(row_logits.to(torch.float32) / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))


def _sample_seed(seed: int, rid: int, step: int) -> int:
    return ((seed * 1_000_003 + rid) * 1_000_003 + step) % (1 << 63)


# ---------------------------------------------------------------------------
# ServeConfig + Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 64
    page_size: int = 8
    n_pages: Optional[int] = None       # default: fully provisioned + trash
    quantize: Optional[str] = None      # "int8" for lossy paged KV
    max_prefill_per_tick: int = 1
    eos_id: Optional[int] = None
    seed: int = 0


class _Slot:
    __slots__ = ("req", "pos", "last", "tokens", "admit_s", "emit_s")

    def __init__(self, req: Request, admit_s: float):
        self.req = req
        self.pos = req.prompt_len     # next cache position to write
        self.last = 0                 # last generated token (decode input)
        self.tokens: List[int] = []
        self.admit_s = admit_s
        self.emit_s: List[float] = []


class Engine:
    """One serving replica on the device of ``params``.  ``sim=SimCosts(...)``
    (with a :class:`SimClock`) runs the identical admission/retirement state
    machine on modeled costs and synthetic tokens — no device work, no
    pool.  Sampling at temperature > 0 draws from a ``torch.Generator``
    seeded per ``(seed, rid, step)``; its draws differ from the reference's
    ``jax.random`` ones."""

    def __init__(self, model, params, cfg: ServeConfig, clock=None,
                 sim: Optional[SimCosts] = None, dtype=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.sim = sim
        self.clock = clock if clock is not None else (
            SimClock() if sim is not None else Clock())
        device = tensor_device(params) if sim is None else None
        self.cache = PagedDecodeCache(
            model, cfg.max_batch, cfg.max_len, cfg.page_size,
            n_pages=cfg.n_pages, quantize=cfg.quantize, dtype=dtype,
            build_pool=sim is None, device=device)
        self.device = self.cache.device
        self.pool = self.cache.pool
        self._slots: List[Optional[_Slot]] = [None] * cfg.max_batch
        self._pending: deque = deque()      # not yet arrived (by arrival_s)
        self._queue: deque = deque()        # arrived, waiting for admission
        self.decode_ticks = 0
        self.prefills = 0

    # -- bookkeeping --------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {req.max_new}")
        if req.prompt_len + req.max_new > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new} exceeds max_len {self.cfg.max_len}")
        self._pending.append(req)
        self._pending = deque(sorted(self._pending,
                                     key=lambda r: (r.arrival_s, r.rid)))

    def load(self) -> int:
        """Outstanding work (router metric): waiting + in flight."""
        return (len(self._pending) + len(self._queue)
                + sum(s is not None for s in self._slots))

    def busy(self) -> bool:
        return self.load() > 0

    def _ingest(self) -> None:
        now = self.clock.now()
        while self._pending and self._pending[0].arrival_s <= now:
            self._queue.append(self._pending.popleft())

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _sample(self, row_logits, temperature: float, rid: int,
                step: int) -> int:
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(row_logits.device).manual_seed(
                _sample_seed(self.cfg.seed, rid, step))
        return sample_token(row_logits, temperature, gen)

    def _sim_token(self, rid: int, step: int) -> int:
        return (rid * 997 + step * 31) % 1000

    # -- the tick -----------------------------------------------------------

    def _admit_one(self, req: Request, slot: int) -> List[Completion]:
        need = req.prompt_len + req.max_new
        self.cache.alloc(slot, need)
        admit_s = self.clock.now()
        if self.sim is not None:
            self.clock.advance(req.prompt_len * self.sim.prefill_s_per_token)
            first = self._sim_token(req.rid, 0)
        else:
            tokens = torch.as_tensor(req.prompt, dtype=torch.int64,
                                     device=self.device)[None, :]
            logits, cache_row = self.model.prefill(
                self.params, {"tokens": tokens}, max_len=self.cfg.max_len)
            first = self._sample(logits[0, -1], req.temperature, req.rid, 0)
            table_row = {L: torch.as_tensor(a.table()[slot], dtype=torch.int64,
                                            device=self.device)
                         for L, a in self.cache.allocators.items()}
            self.pool = self.cache.write_prefill(self.pool, cache_row,
                                                 table_row, slot)
        self.prefills += 1
        s = _Slot(req, admit_s)
        s.last = first
        if req.max_new >= 1:
            # max_new counts the prefill token; max_new=0 requests admit
            # (and pay prefill) but emit nothing
            s.tokens.append(first)
            s.emit_s.append(self.clock.now())
        self._slots[slot] = s
        return self._retire_if_done(slot)

    def _retire_if_done(self, slot: int) -> List[Completion]:
        s = self._slots[slot]
        done = (len(s.tokens) >= s.req.max_new
                or (self.cfg.eos_id is not None and s.tokens
                    and s.tokens[-1] == self.cfg.eos_id))
        if not done:
            return []
        self._slots[slot] = None
        self.cache.free(slot)
        return [Completion(rid=s.req.rid, prompt_len=s.req.prompt_len,
                           tokens=np.asarray(s.tokens, np.int32),
                           arrival_s=s.req.arrival_s, admit_s=s.admit_s,
                           emit_s=list(s.emit_s))]

    def _decode_inputs(self, tokens: np.ndarray, pos: np.ndarray,
                       active: np.ndarray):
        """The tick's host arrays and the page tables on the device:
        (tokens, pos, active, tables)."""
        dev = self.device
        return (torch.as_tensor(tokens, dtype=torch.int64, device=dev),
                torch.as_tensor(pos, dtype=torch.int64, device=dev),
                torch.as_tensor(active, device=dev), self.cache.tables())

    def _decode_on_device(self, tokens_t, pos_t, active_t, tables):
        """The fixed-shape decode step on the device: gather the paged
        cache, decode one token per row, scatter the new entries back.
        Returns (greedy tokens (B,), last-position logits (B, vocab)), both
        on the device; no host read."""
        linear = self.cache.gather(self.pool, tables)
        pos_c = torch.where(active_t, pos_t, 0)
        logits, new_linear = self.model.decode_step(self.params, tokens_t,
                                                    linear, pos_c)
        self.pool = self.cache.scatter_token(self.pool, new_linear, pos_c,
                                             tables, active_t)
        last = logits[:, -1]
        return torch.argmax(last, dim=-1), last

    def _decode(self, tokens: np.ndarray, pos: np.ndarray,
                active: np.ndarray):
        """One decode tick: (greedy tokens (B,) numpy, last-position
        logits (B, vocab))."""
        nxt, last = self._decode_on_device(*self._decode_inputs(tokens, pos,
                                                                active))
        return nxt.cpu().numpy(), last

    def _decode_tick(self) -> List[Completion]:
        B = self.cfg.max_batch
        active = np.array([s is not None for s in self._slots])
        if not active.any():
            return []
        tokens = np.array([[s.last if s else 0] for s in self._slots],
                          np.int64)
        pos = np.array([s.pos if s else 0 for s in self._slots], np.int64)
        self.decode_ticks += 1
        if self.sim is not None:
            self.clock.advance(self.sim.decode_step_s)
            nxt = np.array([self._sim_token(s.req.rid, len(s.tokens))
                            if s else 0 for s in self._slots])
            logits = None
        else:
            nxt, logits = self._decode(tokens, pos, active)
        now = self.clock.now()
        done: List[Completion] = []
        for b in range(B):
            s = self._slots[b]
            if s is None:
                continue
            if self.sim is not None or s.req.temperature <= 0.0:
                tok = int(nxt[b])
            else:
                tok = self._sample(logits[b], s.req.temperature, s.req.rid,
                                   len(s.tokens))
            s.pos += 1
            s.last = tok
            s.tokens.append(tok)
            s.emit_s.append(now)
            done += self._retire_if_done(b)
        return done

    def step(self) -> List[Completion]:
        """One engine tick: ingest arrivals, admit (bounded prefills),
        decode the in-flight batch, retire finished rows."""
        done: List[Completion] = []
        self._ingest()
        if (not self._queue and not any(self._slots) and self._pending):
            self.clock.skip_to(self._pending[0].arrival_s)
            self._ingest()
        admits = 0
        while self._queue and admits < self.cfg.max_prefill_per_tick:
            slot = self._free_slot()
            if slot is None:
                break
            req = self._queue[0]
            if not self.cache.can_admit(req.prompt_len + req.max_new):
                break                      # FCFS: wait for pages to free
            self._queue.popleft()
            done += self._admit_one(req, slot)
            admits += 1
        done += self._decode_tick()
        return done

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        for r in requests:
            self.submit(r)
        out: List[Completion] = []
        while self.busy():
            out += self.step()
        self.cache.check()
        return sorted(out, key=lambda c: c.rid)


# ---------------------------------------------------------------------------
# Static-batching baseline
# ---------------------------------------------------------------------------

def run_static(model, params, requests: Sequence[Request], max_batch: int,
               max_len: int, clock=None,
               sim: Optional[SimCosts] = None) -> List[Completion]:
    """The static-batching baseline: FCFS batches of up to ``max_batch``
    ARRIVED requests; each batch prefills together and decodes in lockstep
    to the batch's LONGEST ``max_new`` (shorter rows pay the padding tax),
    with the scalar-``pos`` decode at the padded ``(max_batch, 1)``
    shape."""
    clock = clock if clock is not None else (
        SimClock() if sim is not None else Clock())
    todo = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
    out: List[Completion] = []
    device = tensor_device(params) if sim is None else None

    while todo:
        if todo[0].arrival_s > clock.now():
            clock.skip_to(todo[0].arrival_s)
        batch = []
        while todo and len(batch) < max_batch \
                and todo[0].arrival_s <= clock.now():
            batch.append(todo.popleft())
        P = batch[0].prompt_len
        if any(r.prompt_len != P for r in batch):
            raise ValueError("static batching pads prompts to one length "
                             "per batch")
        gen = max(r.max_new for r in batch)
        admit_s = clock.now()
        rows = [r.prompt for r in batch]
        rows += [rows[-1]] * (max_batch - len(batch))   # shape padding
        toks: List[List[int]] = [[] for _ in batch]
        emit: List[List[float]] = [[] for _ in batch]

        if sim is not None:
            clock.advance(sum(r.prompt_len for r in batch)
                          * sim.prefill_s_per_token)
            for i, r in enumerate(batch):
                if r.max_new >= 1:
                    toks[i].append((r.rid * 997) % 1000)
                    emit[i].append(clock.now())
            for step in range(1, gen):
                clock.advance(sim.decode_step_s)
                now = clock.now()
                for i, r in enumerate(batch):
                    if step < r.max_new:
                        toks[i].append((r.rid * 997 + step * 31) % 1000)
                        emit[i].append(now)
        else:
            prompts = torch.as_tensor(np.stack(rows), dtype=torch.int64,
                                      device=device)
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          max_len=max_len)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            host = tok[:, 0].cpu().numpy()
            now = clock.now()
            for i, r in enumerate(batch):
                if r.max_new >= 1:
                    toks[i].append(int(host[i]))
                    emit[i].append(now)
            for step in range(1, gen):
                logits, cache = model.decode_step(params, tok, cache,
                                                  P + step - 1)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                host = tok[:, 0].cpu().numpy()
                now = clock.now()
                for i, r in enumerate(batch):
                    if step < r.max_new:
                        toks[i].append(int(host[i]))
                        emit[i].append(now)

        for i, r in enumerate(batch):
            out.append(Completion(rid=r.rid, prompt_len=r.prompt_len,
                                  tokens=np.asarray(toks[i], np.int32),
                                  arrival_s=r.arrival_s, admit_s=admit_s,
                                  emit_s=emit[i]))
    return sorted(out, key=lambda c: c.rid)
