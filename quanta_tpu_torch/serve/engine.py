"""Continuous-batching serving engine.

Port of ``quanta_tpu/serve/engine.py``: a host-side scheduler over the
paged KV pool (``serve/kvcache.py``) and the prefill / multi-step decode
programs (``serve/runner.py``), with the reference's scheduling
semantics:

  admit   - every free slot takes the next waiting request whose prompt
            pages fit (``max_admits_per_step=None``); its prefill runs in
            a length bucket, its KV goes into pages allocated for the
            real prompt length plus one token, and its first token is
            sampled on the device. Nothing is read back.
  decode  - one window of ``multi_step`` tokens for every dispatchable
            slot, after senior-first page growth covering the whole window
            (under pool pressure the newest request is preempted and
            requeued with its output folded into its prompt); the page
            table is sliced to a power-of-two page-width bucket.
  retire  - on EOS or max_new_tokens (the window's overshoot trimmed),
            the slot and its pages are freed for the next admission.

The transport, decided again for a CUDA device next to its host (the JAX
engine's device-resident state, table patches and async-readback lag
were tuned for a TPU behind a 25-33 ms network link):

  - sampled tokens chain on the device through ``_tok_row``, one entry
    per slot, so no dispatch waits for the host;
  - each window's tokens are copied to pinned host memory with
    ``non_blocking=True`` behind a ``torch.cuda.Event`` and read
    ``pipeline_depth`` windows later, so the host waits on nothing it has
    not already queued work behind;
  - each window's inputs (positions, the page-table slice, temperatures,
    top-k: a few hundred bytes) are packed into one pinned int32 buffer
    and uploaded with one non-blocking copy. There is no device-resident
    table cache and so no queued table patch that a preemption could
    leave behind.

Metrics per request: TTFT (arrival to first token on the host); aggregate
throughput over the serving span.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quanta_tpu_torch.serve import kvcache, runner
from quanta_tpu_torch.serve.sampling import SamplingParams


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # filled in by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def finished(self) -> bool:
        return self.t_done > 0


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    seq_len: int = 0  # tokens whose KV is in the pool (or being written)
    admit_seq: int = 0  # monotone admission order (preemption picks newest)

    @property
    def busy(self) -> bool:
        return self.request is not None


def _params_device(params) -> torch.device:
    """The device of the parameter tree's first tensor (the embedding's)."""
    while not isinstance(params, torch.Tensor):
        params = next(iter(params.values() if isinstance(params, dict) else params))
    return params.device


class Engine:
    """Single-device continuous-batching engine over a (possibly
    quantized) Llama parameter tree."""

    def __init__(
        self,
        params,
        cfg,
        *,
        n_slots: int = 8,
        page_size: int = 16,
        n_pages: Optional[int] = None,
        prefill_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024),
        eos_id: Optional[int] = None,
        use_kernel: Optional[bool] = None,
        top_k: int = 0,
        max_top_k: int = 0,
        max_admits_per_step: Optional[int] = None,
        kv_quant: bool = False,
        rng_seed: int = 0,
        recorder=None,
        pipeline: bool = True,
        pipeline_depth: int = 2,
        multi_step: int = 1,
        arch: str = "llama",
    ):
        runner.get_arch(arch)  # raises for an architecture not ported
        self.params = params
        self.cfg = cfg
        self.arch = arch
        self.device = _params_device(params)
        self.n_slots = n_slots
        self.page_size = page_size
        # top_k: engine-wide truncation for every request. max_top_k: the
        # cap under which each request's own sampling.top_k is honored
        # (0: requests asking for one are rejected at submit)
        self.top_k = top_k
        self.max_top_k = max_top_k
        # None = admit into every free slot each step (continuous
        # batching); an int bounds the prefills injected between windows
        self.max_admits_per_step = max_admits_per_step
        self.prefill_buckets = tuple(
            sorted({b for b in prefill_buckets if b < cfg.max_seq_len} | {cfg.max_seq_len}))
        self.eos_id = eos_id
        self.use_kernel = use_kernel
        self.max_pages_per_slot = -(-cfg.max_seq_len // page_size)
        if n_pages is None:  # room for every slot at max_seq_len
            n_pages = 1 + n_slots * self.max_pages_per_slot
        self.kv_quant = kv_quant
        self.pool = kvcache.init_pool(cfg, n_pages, page_size, kv_quant=kv_quant,
                                      device=self.device)
        # decode page-table width buckets (doubling up to the max): the
        # window's pool gather scales with the widest active sequence
        self.decode_page_buckets = []
        b = 1
        while b < self.max_pages_per_slot:
            self.decode_page_buckets.append(b)
            b *= 2
        self.decode_page_buckets.append(self.max_pages_per_slot)
        self.alloc = kvcache.PageAllocator(n_pages)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.waiting: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._page_table = np.zeros((n_slots, self.max_pages_per_slot), np.int32)
        # one generator for admission and decode draws, on the device
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # (ids, width, k) of the last dispatch: a window with the same
        # ones and no scheduling event since counts as steady
        self._last_dispatch = None
        self._sched_dirty = True
        # pipelined stepping: up to ``pipeline_depth`` windows in flight
        # before the oldest is read; pipeline=False reads every window in
        # the step that dispatched it (the synchronous oracle)
        self.pipeline = pipeline
        self.pipeline_depth = max(0, pipeline_depth) if pipeline else 0
        self.multi_step = max(1, multi_step)
        # in-flight windows, FIFO: {"ids": [(slot, uid, seat)], "host":
        # tokens ((off + k, n_slots), pinned host memory once "event" has
        # passed), "event", "k", "off": 1 if row 0 is the window's INPUT
        # token row, "admits": [(slot, uid, seat)] whose first token is
        # that row}
        self._pending: Deque[dict] = deque()
        # slots admitted since the last dispatch: their first token rides
        # row 0 of the next window that includes them
        self._fresh_admit: Dict[int, Tuple[int, int]] = {}
        # the freshest input token of every slot, on the device: admission
        # writes it, each window's last row replaces it
        self._tok_row = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._last_decode_width = 0
        self._steps = 0
        self._decode_tokens = 0
        self._t_serve = 0.0
        self._t_first_dispatch = 0.0
        self._t_last_process = 0.0
        self._admit_counter = 0
        self._admissions = 0
        self._preemptions = 0
        self.recorder = recorder  # optional quanta_tpu_torch.metrics.MetricsRecorder

    # ------------------------------------------------------------ transport

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """One host array to the device: from pinned memory without
        blocking on CUDA (the caching host allocator keeps the pinned
        block until the copy has run)."""
        t = torch.from_numpy(host)
        if not self._cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_readback(self, toks: torch.Tensor) -> dict:
        if not self._cuda:
            return {"host": toks, "event": None}
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return {"host": host, "event": event}

    # ---------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        """Enqueue a request, rejecting up front anything the engine could
        never serve (so the step loop cannot deadlock on the head of line)."""
        prompt_len = len(req.prompt)
        # multi_step > 1 reserves window headroom: a retire found
        # mid-window may have written up to multi_step - 1 positions past
        # the request's own budget
        total_len = prompt_len + req.max_new_tokens + self.multi_step - 1
        if total_len > self.cfg.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prompt ({prompt_len}) + max_new_tokens "
                f"({req.max_new_tokens}) + window headroom ({self.multi_step - 1}) "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")
        worst_pages = self._pages_needed(total_len)
        capacity = self.alloc.n_pages - 1  # page 0 is the reserved null page
        if worst_pages > capacity:
            raise ValueError(
                f"request {req.uid}: worst-case page need {worst_pages} exceeds pool "
                f"capacity {capacity}; raise n_pages")
        if req.sampling.top_k > self.max_top_k:
            raise ValueError(
                f"request {req.uid}: sampling.top_k={req.sampling.top_k} exceeds the "
                f"engine's max_top_k={self.max_top_k}; construct the Engine with a "
                "larger max_top_k")
        req.t_arrival = req.t_arrival or time.perf_counter()
        self.waiting.append(req)

    # ------------------------------------------------------------- scheduler

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _in_flight(self, slot_id: int, uid: int) -> int:
        """Tokens dispatched for (slot, uid) that the host has not read."""
        return sum(e["k"] for e in self._pending
                   for s, u, _seat in e["ids"] if s == slot_id and u == uid)

    def _prefill_into(self, toks: np.ndarray, prompt_len: int, write_pages: List[int]):
        """Prefill one bucketed prompt and write its KV into the pages
        (0 = null page for bucket padding). Returns the last logits."""
        last_logits, k_seq, v_seq = runner.prefill(
            self.params, self._upload(toks), prompt_len, self.cfg,
            use_kernel=self.use_kernel, arch=self.arch)
        kvcache.write_prefill(self.pool, self._upload(np.asarray(write_pages, np.int32)),
                              k_seq, v_seq, use_kernel=self.use_kernel)
        return last_logits

    def _try_admit(self) -> bool:
        """Seat the head of the line into a free slot; True if seated.
        Prefill, KV write and first-token sampling are queued on the
        device; the token is read with the next window that includes it."""
        if not self.waiting:
            return False
        free = [i for i, s in enumerate(self.slots) if not s.busy]
        if not free:
            return False
        req = self.waiting[0]
        prompt_len = len(req.prompt)
        bucket = runner.pick_bucket(prompt_len, self.prefill_buckets)
        # pages for the REAL prompt length (+1 token of headroom for the
        # first decode write), not for the bucket: the bucket's padding
        # writes into the null page, which attention always masks
        n_real = self._pages_needed(max(prompt_len, 1))
        n_keep = self._pages_needed(prompt_len + 1)
        if n_keep > self.alloc.free_pages:
            return False  # pool pressure: wait for a retirement
        self.waiting.popleft()
        slot_id = free[0]
        slot = self.slots[slot_id]

        toks = np.zeros((1, bucket), np.int32)
        toks[0, :prompt_len] = req.prompt
        pages = self.alloc.alloc(n_keep)
        n_bucket_pages = self._pages_needed(bucket)
        last_logits = self._prefill_into(toks, prompt_len,
                                         pages[:n_real] + [0] * (n_bucket_pages - n_real))
        first = runner.sample_one(last_logits, self._gen, req.sampling.temperature,
                                  req.sampling.top_k, top_k=self.top_k,
                                  max_top_k=self.max_top_k)

        slot.request = req
        slot.pages = pages
        slot.seq_len = prompt_len
        self._sched_dirty = True
        self._admit_counter += 1
        self._admissions += 1
        slot.admit_seq = self._admit_counter
        self._page_table[slot_id, :] = 0
        self._page_table[slot_id, :len(pages)] = pages
        self._tok_row[slot_id] = first  # in place, on the device
        self._fresh_admit[slot_id] = (req.uid, slot.admit_seq)
        return True

    def _grow_if_needed(self, slot_id: int, ahead: int = 1) -> bool:
        """Ensure pages for positions ``seq_len .. seq_len + ahead - 1``.
        Returns False if the pool runs out of pages (the caller preempts).
        The table is uploaded with every window, so growth is no
        scheduling event."""
        slot = self.slots[slot_id]
        page_idx = (slot.seq_len + ahead - 1) // self.page_size
        if page_idx >= self.max_pages_per_slot:
            raise MemoryError(
                f"request {slot.request.uid} exceeded max_seq_len {self.cfg.max_seq_len}")
        while len(slot.pages) <= page_idx:
            if self.alloc.free_pages < 1:
                return False
            (new_page,) = self.alloc.alloc(1)
            slot.pages.append(new_page)
            self._page_table[slot_id, len(slot.pages) - 1] = new_page
        return True

    def _release(self, slot_id: int) -> None:
        self.alloc.free(self.slots[slot_id].pages)
        self._page_table[slot_id, :] = 0
        self.slots[slot_id] = _Slot()
        self._fresh_admit.pop(slot_id, None)
        self._sched_dirty = True

    def _preempt(self, slot_id: int) -> None:
        """Evict a running request under pool pressure: free its pages and
        requeue it at the head of the line with its generated tokens folded
        into the prompt, so re-admission re-prefills the whole context and
        generation resumes where it stopped (t_first_token and the
        max_new_tokens budget are kept). Its in-flight tokens are dropped
        when read (seat mismatch) and drawn again after re-admission."""
        req = self.slots[slot_id].request
        req.prompt = np.concatenate([np.asarray(req.prompt, np.int32),
                                     np.asarray(req.output, np.int32)])
        self._release(slot_id)
        self.waiting.appendleft(req)
        self._preemptions += 1
        if self.recorder is not None:
            self.recorder.count("preemptions", 1)

    def _ensure_growth(self, slot_id: int, ahead: int = 1) -> None:
        """Backpressure instead of MemoryError: preempt the most recently
        admitted OTHER request until this slot can grow. Submit-time checks
        guarantee that a lone request's worst case fits the pool."""
        while not self._grow_if_needed(slot_id, ahead):
            victims = [i for i, s in enumerate(self.slots) if s.busy and i != slot_id]
            if not victims:
                raise MemoryError(
                    f"KV pool exhausted with a single active request (uid "
                    f"{self.slots[slot_id].request.uid}); this should be impossible "
                    "past the submit-time capacity check")
            self._preempt(max(victims, key=lambda i: self.slots[i].admit_seq))

    def _maybe_finish(self, slot_id: int, token: int) -> bool:
        req = self.slots[slot_id].request
        done = len(req.output) >= req.max_new_tokens or (
            self.eos_id is not None and token == self.eos_id)
        if done:
            req.t_done = time.perf_counter()
            self.finished.append(req)
            self._release(slot_id)
        return done

    # ------------------------------------------------------------- step loop

    def _window_inputs(self, cand: List[int], width: int):
        """Positions, temperatures, top-k and the table slice of one
        window, packed into ONE int32 host array and uploaded in one copy."""
        n = self.n_slots
        packed = np.zeros((3 * n + n * width,), np.int32)
        positions, top_ks = packed[:n], packed[n:2 * n]
        temps = packed[2 * n:3 * n].view(np.float32)
        positions[:] = -1
        for i in cand:
            s = self.slots[i]
            positions[i] = s.seq_len
            temps[i] = s.request.sampling.temperature
            top_ks[i] = s.request.sampling.top_k
        packed[3 * n:] = self._page_table[:, :width].reshape(-1)
        t0 = time.perf_counter()
        dev = self._upload(packed)
        if self.recorder is not None:
            self.recorder.observe("window_upload", time.perf_counter() - t0)
        return (dev[:n], dev[2 * n:3 * n].view(torch.float32), dev[n:2 * n],
                dev[3 * n:].view(n, width))

    def _dispatch(self) -> int:
        """Queue ONE decode window for every dispatchable slot, without
        reading anything back. Returns the slots dispatched.

        A slot is dispatchable if its in-flight tokens cannot already
        exhaust its budget. Growth for every position the window writes is
        ensured first (senior first, preempting the newest under pressure);
        seq_len then advances optimistically; reading only appends tokens
        and retires."""
        cand = []
        for i, s in enumerate(self.slots):
            if not s.busy:
                continue
            rem = (s.request.max_new_tokens - len(s.request.output)
                   - self._in_flight(i, s.request.uid))
            if rem > 0:
                cand.append(i)  # else it retires when its tokens are read
        if not cand:
            return 0
        # the window is always multi_step tokens; an overshoot past a
        # budget is trimmed when read (submit() reserved the headroom)
        k = self.multi_step
        for i in sorted(cand, key=lambda i: self.slots[i].admit_seq):
            if self.slots[i].busy:
                self._ensure_growth(i, ahead=k)
        cand = [i for i in cand if self.slots[i].busy]  # preemption culls
        if not cand:
            return 0

        # the page-table width bucket of the widest sequence: the window
        # reads up to position seq_len + k - 1
        need = max((self.slots[i].seq_len + k - 1) // self.page_size + 1 for i in cand)
        width = next(b for b in self.decode_page_buckets if b >= need)
        self._last_decode_width = width
        ids = [(i, self.slots[i].request.uid, self.slots[i].admit_seq) for i in cand]
        steady = not self._sched_dirty and self._last_dispatch == (ids, width, k)

        positions, temps, top_ks, table = self._window_inputs(cand, width)
        tokens_in = self._tok_row
        toks_seq, next_positions, self.pool = runner.decode_multi_step(
            self.params, self.pool, table, positions, tokens_in, self._gen, temps,
            top_ks, self.cfg, self.page_size, k, use_kernel=self.use_kernel,
            top_k=self.top_k, max_top_k=self.max_top_k, arch=self.arch)
        # admissions since the last dispatch ride along: their first token
        # IS this window's input row, read back with the window
        admits = []
        for i in cand:
            fa = self._fresh_admit.pop(i, None)
            s = self.slots[i]
            if fa == (s.request.uid, s.admit_seq):
                admits.append((i, fa[0], fa[1]))
        if admits:
            toks_store, off = torch.cat([tokens_in[None], toks_seq], dim=0), 1
        else:
            toks_store, off = toks_seq, 0
        readback = self._start_readback(toks_store)
        self._tok_row = torch.where(next_positions >= 0, toks_seq[-1], self._tok_row)
        for i in cand:
            self.slots[i].seq_len += k
        self._last_dispatch = (ids, width, k)
        self._sched_dirty = False
        self._steps += 1
        if not self._t_first_dispatch:
            self._t_first_dispatch = time.perf_counter()
        if self.recorder is not None:
            self.recorder.count("decode_dispatches", 1)
            if steady:
                self.recorder.count("steady_steps", 1)
        self._pending.append({"ids": ids, "k": k, "off": off, "admits": admits, **readback})
        return len(cand)

    def _process_due(self, min_batches: int = 0) -> int:
        """Read every in-flight window beyond the pipeline depth (at least
        ``min_batches``) and do the host bookkeeping: append, retire on
        EOS or budget. Returns the tokens kept."""
        n_due = min(max(len(self._pending) - self.pipeline_depth, min_batches),
                    len(self._pending))
        kept = 0
        for _ in range(n_due):
            entry = self._pending.popleft()
            t0 = time.perf_counter()
            if entry["event"] is not None:
                entry["event"].synchronize()
            tokens = entry["host"].numpy()  # (off + k, n_slots)
            # admissions riding this window: row 0 is their first token
            for slot_id, uid, seat in entry["admits"]:
                slot = self.slots[slot_id]
                if slot.request is None or slot.request.uid != uid or slot.admit_seq != seat:
                    continue  # preempted since: the token is drawn again
                tok = int(tokens[0, slot_id])
                req = slot.request
                if not req.t_first_token:  # kept across preemption
                    req.t_first_token = time.perf_counter()
                req.output.append(tok)
                kept += 1
                self._maybe_finish(slot_id, tok)
            decoded = 0
            for t in range(entry["off"], entry["off"] + entry["k"]):
                for slot_id, uid, seat in entry["ids"]:
                    slot = self.slots[slot_id]
                    if (slot.request is None or slot.request.uid != uid
                            or slot.admit_seq != seat):
                        continue  # preempted or retired: the tail is dropped
                    tok = int(tokens[t, slot_id])
                    slot.request.output.append(tok)
                    decoded += 1
                    self._maybe_finish(slot_id, tok)
            kept += decoded
            self._decode_tokens += decoded
            if self.recorder is not None:
                self.recorder.count("decode_tokens", decoded)
                self.recorder.observe("decode_step", time.perf_counter() - t0)
        if n_due:
            self._t_last_process = time.perf_counter()
        return kept

    def step(self) -> int:
        """Admit (up to ``max_admits_per_step``; every free slot by
        default), queue one decode window, then read in-flight windows down
        to the pipeline depth. Returns the tokens read (0 while the
        pipeline fills)."""
        budget = self.max_admits_per_step
        if budget is None or not any(s.busy for s in self.slots):
            budget = self.n_slots
        while budget > 0 and self._try_admit():
            budget -= 1
        dispatched = self._dispatch()
        # with nothing dispatched, read at least one window so the loop
        # always makes progress
        return self._process_due(min_batches=0 if dispatched else 1)

    @property
    def _draining(self) -> bool:
        return bool(self.waiting or self._pending or any(s.busy for s in self.slots))

    @property
    def idle(self) -> bool:
        """True when nothing is queued, in flight or seated."""
        return not self._draining

    def warm_widths(self, max_width_need: int, max_prompt_len: Optional[int] = None) -> None:
        """Run every program the engine can reach once before a measured
        trace: the decode window at every page-width bucket up to and
        including the first >= ``max_width_need``, and, given
        ``max_prompt_len``, the prefill (+ KV write + first-token sample)
        of every bucket such a prompt can land in. Every dummy slot is
        inactive, so the pool changes only in the null page. Resets the
        throughput counters."""
        zeros = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
        if max_prompt_len is not None:
            for b in self.prefill_buckets:
                logits = self._prefill_into(np.zeros((1, b), np.int32), 1,
                                            [0] * self._pages_needed(b))
                runner.sample_one(logits, self._gen, 0.0, 0, top_k=self.top_k,
                                  max_top_k=self.max_top_k)
                if b >= max_prompt_len:
                    break
        for b in self.decode_page_buckets:
            runner.decode_multi_step(
                self.params, self.pool,
                torch.zeros((self.n_slots, b), dtype=torch.int32, device=self.device),
                zeros - 1, zeros, self._gen,
                torch.zeros((self.n_slots,), dtype=torch.float32, device=self.device), zeros,
                self.cfg, self.page_size, self.multi_step, use_kernel=self.use_kernel,
                top_k=self.top_k, max_top_k=self.max_top_k, arch=self.arch)
            if b >= max_width_need:
                break
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self._steps = 0
        self._decode_tokens = 0
        self._t_serve = 0.0
        self._t_first_dispatch = 0.0
        self._t_last_process = 0.0

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve a batch of requests to completion; returns them finished."""
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while self._draining:
            self.step()
        self._t_serve += time.perf_counter() - t0
        return self.finished

    # --------------------------------------------------------------- metrics

    def metrics(self) -> Dict[str, float]:
        ttfts = sorted(r.ttft for r in self.finished if r.t_first_token)
        total_out = sum(len(r.output) for r in self.finished)
        # callers stepping the engine themselves (no run()) still get a
        # throughput: the first-dispatch -> last-read span
        span = self._t_serve or (
            self._t_last_process - self._t_first_dispatch
            if self._t_last_process > self._t_first_dispatch else 0.0)
        m = {
            "requests_finished": len(self.finished),
            "output_tokens": total_out,
            "decode_steps": self._steps,
            "admissions": self._admissions,
            "serve_seconds": round(span, 4),
            "throughput_tok_s": round(total_out / span, 1) if span else 0.0,
            "pool_pages_free": self.alloc.free_pages,
            "preemptions": self._preemptions,
        }
        if ttfts:
            m["ttft_p50_ms"] = round(1e3 * ttfts[len(ttfts) // 2], 2)
            m["ttft_p99_ms"] = round(
                1e3 * ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 2)
        if self.recorder is not None:
            m.update(self.recorder.snapshot())
        return m
