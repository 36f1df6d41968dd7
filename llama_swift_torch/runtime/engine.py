"""Continuous-batching inference engine (counterpart of
``llama_swift_tpu/runtime/engine.py``).

The reference serves exactly one stream, reloading the model per prompt
(``LlamaRunnerBridge.mm:45-48``).  This engine holds the model once and
multiplexes up to ``max_slots`` concurrent streams through one batched
decode step per tick:

* the KV cache carries a slot axis: dense ``[L, B, H, n_ctx, Dh]``, or a
  page pool with a page table (``paged_pages``), where a slot takes pages
  as its sequence grows and gives them back when it retires; either in
  f32, bf16 or int8 (``cache_dtype``);
* each step advances every *active* slot by one token through
  :func:`models.llama.forward_batched` (every matmul sees all B rows, so
  the weights stream once per step);
* admission is a chunked prefill into the slot's cache planes, one
  ``prefill_bucket``-sized chunk per step, so active slots keep decoding
  while a long prompt admits;
* sampling runs on the device for all slots in one call when every active
  slot can (unseeded, same ring size and top-k), else on the host with the
  reference-exact per-slot sampler (``runtime/sampler.py``).

Everything lives on the params' device: cache, page table, rings and the
per-step index tensors.  The JAX engine's jitted ``_set_cell/_set_row/
_set_elem`` helpers, which only dodge XLA recompiles, are plain in-place
index assignments here.

API: :meth:`Engine.submit` → :class:`StreamHandle` (blocking iterator of
token strings); :meth:`Engine.step` runs one tick synchronously, and the
engine loop can run it in a background thread (``with engine:``).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import secrets
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, SamplingConfig
from ..models import llama as model_lib
from ..tokenizer import Vocab
from .device_sampler import sample_tokens_batched
from .errors import PredictionFailedError
from .sampler import SamplerState

#: ``stats["ttft_s"]`` keeps the time to first token of the last this many
#: requests, so a long-lived engine's stats stay bounded
TTFT_WINDOW = 1024


def batched_decode(params, tokens, n_pasts, cache, cfg: ModelConfig):
    """One decode step for every slot: tokens ``[B]`` on the device,
    n_pasts ``[B]`` host ints → (logits ``[B, n_vocab]``, cache)."""
    return model_lib.forward_batched(params, tokens, n_pasts, cache, cfg)


def batched_decode_sampled(
    params, tokens, n_pasts, active, cache, rings, ring_pos, generator,
    temps, top_ps, penalties, cfg: ModelConfig, top_k: int, penalize: bool,
):
    """One decode step for every slot with on-device sampling: the only
    device-to-host traffic is the B sampled ids the caller reads.

    rings ``[B, R]`` per-slot last-n buffers (oldest at ``ring_pos``),
    temps/top_ps/penalties ``[B]`` f32 per-slot parameters; ``top_k`` and
    ``penalize`` are shared.  Inactive slots' draws are discarded and their
    rings left untouched: ``rings`` and ``ring_pos`` are updated in place
    for the ``active [B]`` (bool) slots only.  Returns (tokens ``[B]``, cache).
    """
    logits, cache = model_lib.forward_batched(params, tokens, n_pasts, cache, cfg)
    toks = sample_tokens_batched(
        logits, rings, generator, top_k=top_k, penalize=penalize,
        temps=temps, top_ps=top_ps, penalties=penalties,
    )
    rows = torch.arange(rings.shape[0], device=rings.device)
    pushed = rings.clone()
    pushed[rows, ring_pos] = toks
    rings.copy_(torch.where(active[:, None], pushed, rings))
    ring_pos.copy_(torch.where(active, (ring_pos + 1) % rings.shape[1], ring_pos))
    return toks, cache


def slot_prefill_chunk(params, tokens, n_past: int, slot: int, cache, cfg: ModelConfig):
    """Prefill one (padded) prompt chunk into slot ``slot``'s cache planes
    or pages, in place.  Returns (chunk logits ``[P, n_vocab]``, cache)."""
    return model_lib.forward(params, tokens, n_past, cache, cfg, slot=slot)


@dataclasses.dataclass
class _Request:
    prompt_ids: list
    sampling: SamplingConfig
    handle: "StreamHandle"
    reverse_ids: list


@dataclasses.dataclass
class _Slot:
    active: bool = False  # decoding (prefill complete)
    n_past: int = 0
    remaining: int = 0
    last_token: int = 0
    sampler: Optional[SamplerState] = None
    handle: Optional["StreamHandle"] = None
    reverse_ids: list = dataclasses.field(default_factory=list)
    generated: list = dataclasses.field(default_factory=list)
    # admission state: prompt ids not yet prefilled (one chunk per step)
    prefill_ids: list = dataclasses.field(default_factory=list)
    prefill_pos: int = 0
    sampling: Optional[SamplingConfig] = None
    #: host ring advanced since the device ring copy (activation or a
    #: host-sampled step): the device step re-syncs before sampling
    ring_dirty: bool = True
    #: page ids owned by this slot (paged mode), in position order
    pages: list = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.handle is not None and not self.active


class StreamHandle:
    """Per-request token stream: iterate to receive token strings."""

    _DONE = object()

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.error: Optional[BaseException] = None
        self.token_ids: list[int] = []
        self.t_submit: float = time.perf_counter()
        #: wall seconds from submit to the FIRST sampled token (admission
        #: queueing + chunked prefill under load)
        self.ttft_s: Optional[float] = None

    def _put(self, s: str):
        self._q.put(s)

    def _finish(self, error: Optional[BaseException] = None):
        self.error = error
        self._q.put(self._DONE)

    def tokens(self, timeout: Optional[float] = None):
        """Token strings as they arrive; raises the stream's error at its
        end, and ``TimeoutError`` if ``timeout`` seconds pass with none."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"no token for {timeout} s") from None
            if item is self._DONE:
                if self.error:
                    raise self.error
                return
            yield item

    def __iter__(self):
        return self.tokens()

    def text(self) -> str:
        return "".join(self)


class Engine:
    """Slot-based continuous-batching engine over one loaded model.

    ``params`` come from ``models.llama.params_from_*``; the engine runs on
    their device.  ``paged_pages``: page-pool size including one scratch
    page (paged KV mode); None for the dense batched cache.
    ``cache_dtype``: ``torch.float32``, ``torch.bfloat16`` or ``torch.int8``
    (codes plus one f32 scale per (head, position) row; the scale pools of
    a paged int8 cache share the page ids, so page allocation is the same).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        vocab: Vocab,
        *,
        max_slots: int = 8,
        prefill_bucket: int = 64,
        cache_dtype=torch.float32,
        device_sampling: bool = True,
        ring_size: int = 64,
        seed: Optional[int] = None,
        paged_pages: Optional[int] = None,
        page: int = 128,
    ):
        self.params = params
        self.cfg = cfg
        self.vocab = vocab
        self.device = params["norm"].device
        self.max_slots = max_slots
        self.prefill_bucket = prefill_bucket
        self.paged = paged_pages is not None
        if self.paged:
            self.page = min(page, cfg.n_ctx)
            self.cache = model_lib.init_cache_paged(
                cfg, paged_pages, max_slots, dtype=cache_dtype, page=self.page, device=self.device,
            )
            # the last page is the scratch page of unallocated table entries
            self._free_pages = list(range(paged_pages - 1))
        else:
            self.cache = model_lib.init_cache_batched(cfg, max_slots, dtype=cache_dtype, device=self.device)
        self.slots = [_Slot() for _ in range(max_slots)]
        #: on-device sampling when every active slot shares the engine's ring
        #: size and top_k and asks for no fixed seed; otherwise the step
        #: samples on the host (per-request seeds keep their numpy stream)
        self.device_sampling = device_sampling
        self.ring_size = max(1, ring_size)
        self.rings = torch.zeros((max_slots, self.ring_size), dtype=torch.int64, device=self.device)
        self.ring_pos = torch.zeros(max_slots, dtype=torch.int64, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(secrets.randbits(31) if seed is None else seed))
        self._pending: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {
            "decode_steps": 0, "device_sampled_steps": 0, "prefill_chunks": 0,
            "tokens_generated": 0, "admitted": 0,
        }
        #: the fatal exception once a step crashed: live and pending streams
        #: were failed with it, and submits are rejected
        self.dead: Optional[BaseException] = None

    # ------------------------------------------------------------------

    def submit(
        self,
        prompt: str,
        sampling: Optional[SamplingConfig] = None,
        *,
        reverse_prompt: Optional[str] = None,
    ) -> StreamHandle:
        sampling = sampling or SamplingConfig()
        handle = StreamHandle()
        if self.dead is not None:
            handle._finish(self.dead)
            return handle
        prompt_ids = self.vocab.tokenize(prompt, bos=True)
        if len(prompt_ids) >= self.cfg.n_ctx:
            prompt_ids = prompt_ids[: self.cfg.n_ctx - 1]
        reverse_ids = self.vocab.tokenize(reverse_prompt, bos=False) if reverse_prompt else []
        self._pending.put(_Request(prompt_ids, sampling, handle, reverse_ids))
        return handle

    # ------------------------------------------------------------------

    def _alloc_pages(self, idx: int, slot: _Slot, n: int) -> bool:
        """Give slot ``idx`` ``n`` more pages and point its table row at
        them; False if the pool is exhausted."""
        if n <= 0:
            return True
        if len(self._free_pages) < n:
            return False
        new = [self._free_pages.pop() for _ in range(n)]
        lo = len(slot.pages)
        slot.pages.extend(new)
        self.cache["page_table"][idx, lo : lo + n] = torch.tensor(new, dtype=torch.int32)
        return True

    def _free_slot_pages(self, idx: int, slot: _Slot) -> None:
        if not self.paged or not slot.pages:
            return
        self._free_pages.extend(slot.pages)
        slot.pages = []
        # idle slots are still stepped (all B lanes): repoint the row at the
        # scratch page so their writes never land on a reallocated page
        self.cache["page_table"][idx] = self.cache["k_pool"].shape[0] - 1

    def _admit(self) -> None:
        """Assign pending requests to free slots (bookkeeping only: the
        prefill runs one chunk per step in :meth:`_prefill_tick`).  Paged
        mode reserves the prompt's pages here, deferring admission while
        the pool is full; decode pages are allocated per step."""
        for idx, slot in enumerate(self.slots):
            if slot.active or slot.prefilling:
                continue
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            if self.paged:
                need = max(1, -(-len(req.prompt_ids) // self.page))
                if not self._alloc_pages(idx, slot, need):
                    self._pending.put(req)  # pool full: retry next step
                    return
            sampler = SamplerState(req.sampling)
            for t in req.prompt_ids:
                sampler.observe(t)
                req.handle.token_ids.append(t)
                req.handle._put(self.vocab.piece_str(t))  # prompt echo (.mm:892)
            slot.handle = req.handle
            slot.sampler = sampler
            slot.sampling = req.sampling
            slot.reverse_ids = req.reverse_ids
            slot.prefill_ids = req.prompt_ids
            slot.prefill_pos = 0
            slot.generated = []
            self.stats["admitted"] += 1

    def _prefill_tick(self) -> None:
        """Advance ONE prefilling slot by ONE prompt chunk, so active slots
        wait at most one chunk's forward per step."""
        for idx, slot in enumerate(self.slots):
            if not slot.prefilling:
                continue
            length = len(slot.prefill_ids)
            chunk = slot.prefill_ids[slot.prefill_pos : slot.prefill_pos + self.prefill_bucket]
            padded, clen = model_lib.pad_tokens(chunk, self.prefill_bucket)
            # the padding never runs past n_ctx (the JAX engine's
            # dynamic_update_slice would clamp the chunk's start instead)
            padded = padded[: self.cfg.n_ctx - slot.prefill_pos]
            logits, self.cache = slot_prefill_chunk(
                self.params, torch.as_tensor(padded.astype(np.int64), device=self.device),
                slot.prefill_pos, idx, self.cache, self.cfg,
            )
            self.stats["prefill_chunks"] += 1
            slot.prefill_pos += clen
            if slot.prefill_pos < length:
                return  # more chunks to go; decode continues meanwhile
            # prompt fully prefilled: sample the first token, go active
            first = slot.sampler.sample(logits[clen - 1].cpu().numpy())
            slot.handle.ttft_s = time.perf_counter() - slot.handle.t_submit
            self.stats.setdefault("ttft_s", collections.deque(maxlen=TTFT_WINDOW)).append(slot.handle.ttft_s)
            slot.ring_dirty = True
            n_predict = min(slot.sampling.n_predict, self.cfg.n_ctx - length)
            slot.active = True
            slot.n_past = length
            slot.remaining = n_predict
            slot.last_token = first
            slot.generated = [first]
            self._emit_or_retire(slot, first)
            return

    def _emit_or_retire(self, slot: _Slot, token: int) -> None:
        """Emit a sampled token (or retire on reverse-prompt/budget)."""
        if slot.reverse_ids and slot.generated[-len(slot.reverse_ids):] == slot.reverse_ids:
            self._retire(slot)
            return
        slot.handle.token_ids.append(token)
        slot.handle._put(self.vocab.piece_str(token))
        self.stats["tokens_generated"] += 1
        slot.remaining -= 1
        if slot.remaining <= 0 or slot.n_past + 1 >= self.cfg.n_ctx:
            self._retire(slot)

    def _retire(self, slot: _Slot, error: Optional[BaseException] = None) -> None:
        slot.handle._finish(error)
        slot.active = False
        slot.handle = None
        slot.sampler = None
        self._free_slot_pages(self.slots.index(slot), slot)

    # ------------------------------------------------------------------

    def _device_scfg(self, active) -> Optional[SamplingConfig]:
        """The shared SamplingConfig if every active slot can take the
        on-device sampler this step, else None (host sampling)."""
        if not self.device_sampling:
            return None
        s0 = self.slots[active[0]].sampling
        for i in active:
            s = self.slots[i].sampling
            if s.seed is not None:
                return None  # per-request determinism -> host RNG stream
            if max(1, s.repeat_last_n) != self.ring_size:
                return None
            if s.top_k != s0.top_k or (s.repeat_last_n > 0) != (s0.repeat_last_n > 0):
                return None
        return s0

    def step(self) -> int:
        """Admit pending requests, advance at most one prefill chunk, run
        one batched decode step.  Returns the number of active slots stepped."""
        self._admit()
        self._prefill_tick()
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        if self.paged:
            # this step writes position n_past of each slot: grow on demand;
            # a slot that cannot get a page fails its stream (capacity)
            for i in active:
                slot = self.slots[i]
                need = slot.n_past // self.page + 1
                if need > len(slot.pages) and not self._alloc_pages(i, slot, need - len(slot.pages)):
                    self._retire(slot, PredictionFailedError("KV page pool exhausted"))
            active = [i for i in active if self.slots[i].active]
            if not active:
                return 0
        tokens = np.zeros(self.max_slots, dtype=np.int64)
        n_pasts = np.zeros(self.max_slots, dtype=np.int64)
        for i, slot in enumerate(self.slots):
            if slot.active:
                tokens[i] = slot.last_token
                n_pasts[i] = slot.n_past
            elif slot.prefilling:
                # an idle lane still writes K/V at its n_past: point a
                # prefilling slot's lane at its next chunk's first position,
                # which that chunk overwrites (position 0 would clobber the
                # prompt's first chunk)
                n_pasts[i] = slot.prefill_pos
        tokens_dev = torch.as_tensor(tokens, device=self.device)

        s0 = self._device_scfg(active)
        if s0 is not None:
            for i in active:
                slot = self.slots[i]
                if slot.ring_dirty:
                    buf = [0] * self.ring_size + list(slot.sampler.ring)
                    self.rings[i] = torch.tensor(buf[-self.ring_size :], dtype=torch.int64)
                    self.ring_pos[i] = 0
                    slot.ring_dirty = False
            params = np.ones((3, self.max_slots), np.float32)  # temps, top_ps, penalties
            mask = np.zeros(self.max_slots, bool)
            for i in active:
                s = self.slots[i].sampling
                params[:, i] = (s.temp, s.top_p, s.repeat_penalty)
                mask[i] = True
            params_dev = torch.as_tensor(params, device=self.device)
            toks, self.cache = batched_decode_sampled(
                self.params, tokens_dev, n_pasts, torch.as_tensor(mask, device=self.device),
                self.cache, self.rings, self.ring_pos, self.generator,
                params_dev[0], params_dev[1], params_dev[2], self.cfg,
                min(int(s0.top_k), self.cfg.n_vocab), s0.repeat_last_n > 0,
            )
            out = toks.cpu().numpy()
            self.stats["decode_steps"] += 1
            self.stats["device_sampled_steps"] += 1
            for i in active:
                slot = self.slots[i]
                slot.n_past += 1
                token = int(out[i])
                # mirror into the host ring so a later host step (or re-sync)
                # sees the full window; not dirty: the device ring advanced
                slot.sampler.ring.append(token)
                slot.generated.append(token)
                slot.last_token = token
                self._emit_or_retire(slot, token)
            return len(active)

        logits, self.cache = batched_decode(self.params, tokens_dev, n_pasts, self.cache, self.cfg)
        logits = logits.cpu().numpy()
        self.stats["decode_steps"] += 1
        for i in active:
            slot = self.slots[i]
            slot.n_past += 1
            token = slot.sampler.sample(logits[i])
            slot.ring_dirty = True
            slot.generated.append(token)
            slot.last_token = token
            self._emit_or_retire(slot, token)
        return len(active)

    # ------------------------------------------------------------------

    def _fail_all(self, e: BaseException) -> None:
        """A crashed step finishes every live and pending handle with the
        error, so no client hangs (the reference's failed-event path,
        ``LlamaPredictOperation.mm:791-793``)."""
        with self._lock:
            for slot in self.slots:
                if slot.handle is not None:
                    slot.handle._finish(e)
                    slot.active = False
                    slot.handle = None
            while True:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                req.handle._finish(e)

    def _loop(self):
        while not self._stop.is_set():
            try:
                stepped = self.step()
            except BaseException as e:  # noqa: BLE001
                # a step that failed part-way may have written only some of
                # the cache: the engine cannot safely continue
                logging.getLogger(__name__).exception("engine step failed; marking engine dead")
                self.dead = e
                self._fail_all(e)
                return
            if stepped == 0 and self._pending.empty():
                time.sleep(0.001)

    def start(self) -> "Engine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
