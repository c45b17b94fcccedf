"""Serving engine on PyTorch: chunked prefill + continuous batching.

The port of `repro/launch/serve.py`: a full-precision or quantized KV
cache, contiguous or paged, with optional sliding windows.  Its parts:

  * `Request`, `BlockAllocator`, `PagedPool`, `Scheduler` — the JAX
    package's pure-Python scheduling policy, copied verbatim (the tests
    pin the copies to their originals' source).
  * `TorchEngine` — `JaxEngine`'s interface over the port's `Model`:
    ``prefill_unit``, ``prefill_step`` (one C-token chunk into one slot,
    `Model.prefill_into`; or one token through a whole-batch decode tick
    in the ``"decode"`` baseline mode) and ``decode_step`` (one batched
    tick, `Model.decode`), over a contiguous cache or, with ``paged=True``,
    page pools addressed through a `PagedPool`'s block tables, and with
    ``window=W`` sliding-window attention; ``export_slot``/``import_slot``
    move one slot's pages (the fleet's KV handoff).  ``quantize="int8"``
    or ``"fp8"`` serves the weights in storage form (int8 or fp8 codes
    with per-channel scales: the seeded draws or a full-precision
    ``params`` tree through ``quantize_tree``, or a tree already in that
    form) over a KV cache of the same format, as the JAX engine's
    ``quantize=``.  Without it, a storage-form tree serves through
    ``params`` over the full-precision cache.
  * `Server` and `main` — the JAX package's facade and CLI (with
    ``--quantize``), plus ``--device``.  The JAX engine's admission
    control of the deployment's footprint (``memory_budget``) is not
    ported.

Every op the model calls goes through the container's binding, so on the
card rmsnorm and the attention ops run the CUDA kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.manifest import quantize_tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, torch_tree
from repro_torch.core.runtime import Runtime
from repro_torch.kernels.quant import storage_dtype
from repro_torch.launch.bundle import make_bundle
from repro_torch.models.model import Model, tree_items

__all__ = ["BlockAllocator", "PagedPool", "Request", "Scheduler", "TorchEngine",
           "Server", "SERVING_STATS_SCHEMA", "main", "serves_reduced"]

# scheduler states (the JAX package's docs/serving.md state machine)
QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
HANDOFF = "handoff"     # fleet mode: prefill finished, state in transit
DONE = "done"

# admission rejection reasons
REJECT_QUEUE_FULL = "queue-full"
REJECT_TOO_LONG = "too-long"

# Scheduler.consolidated_stats() keys, pinned as in the JAX package.
SERVING_STATS_SCHEMA = frozenset({
    "submitted", "completed", "rejected-queue-full", "rejected-too-long",
    "handed-off", "adopted", "peak-active", "ticks",
    "pages-capacity", "pages-allocated-mean", "pages-written-mean",
    "pages-allocated-peak", "fragmentation-pct",
})


@dataclasses.dataclass
class Request:
    """One generation request plus its complete serving record.

    The scheduler fills in the lifecycle fields; the benchmark reads
    them.  Timestamps come from the scheduler's injected clock, so a
    fake clock makes TTFT accounting exactly reproducible in tests.

    Attributes:
      rid: caller-chosen id (echoed in emitted (rid, token) pairs).
      prompt: (prompt_len,) int32 prompt tokens.
      max_new: generation budget; the scheduler may clamp it to its
        per-request cap at submit time.
      tokens: generated tokens (greedy argmax), filled during serving.
      state: queued -> prefilling -> decoding -> done.
      slot: cache row while admitted, else None.
      prefill_pos: prompt tokens ingested so far.
      next_pos: cache position the next fed token will be written to.
      submit_t / first_token_t / finish_t: clock readings; TTFT is
        first_token_t - submit_t (first token falls out of the final
        prefill chunk's logits on the chunked path, out of the first
        decode tick on the baseline path).
      prefill_steps / decode_steps: compiled steps this request consumed
        — the regression-pinned invariant is prefill_steps ==
        ceil(prompt_len / C) and decode_steps == max_new - 1 on the
        chunked path.
    """

    rid: int
    prompt: np.ndarray
    max_new: int
    tokens: list = dataclasses.field(default_factory=list)
    state: str = QUEUED
    slot: int | None = None
    prefill_pos: int = 0
    next_pos: int = 0
    submit_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None
    prefill_steps: int = 0
    decode_steps: int = 0
    order: int = -1     # FCFS sequence number, assigned at submit

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def ttft(self) -> float | None:
        if self.first_token_t is None or self.submit_t is None:
            return None
        return self.first_token_t - self.submit_t


class BlockAllocator:
    """Pure-python page bookkeeping for the paged KV cache.

    All-or-nothing allocation: `alloc(owner, n)` hands out n pages or
    None (never a partial grant — a half-provisioned request could not
    be admitted anyway), `free(owner)` returns every page the owner
    held.  Reserved pages (the park page) are never handed out.  The
    invariants the hypothesis suite pins (tests/test_block_allocator.py):
    no page is owned twice, free returns exactly what alloc granted, and
    pages-in-use never exceeds the pool.
    """

    def __init__(self, num_pages: int, *, reserved: int = 0):
        if num_pages <= reserved:
            raise ValueError(f"pool of {num_pages} pages with {reserved} reserved")
        self.num_pages = num_pages
        self.reserved = tuple(range(reserved))
        # stack of free page ids; pop() from the end -> lowest index first
        self._free = list(range(num_pages - 1, reserved - 1, -1))
        self.owned: dict[int, list[int]] = {}

    @property
    def capacity(self) -> int:
        return self.num_pages - len(self.reserved)

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, owner, n: int) -> list[int] | None:
        if owner in self.owned:
            raise ValueError(f"owner {owner!r} already holds pages")
        if n < 1:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.owned[owner] = pages
        return list(pages)

    def free(self, owner) -> list[int]:
        pages = self.owned.pop(owner, [])
        self._free.extend(pages)
        return list(pages)


class PagedPool:
    """BlockAllocator + per-slot block tables — the paged cache's map.

    Page size equals the prefill chunk C, so each compiled prefill step
    fills exactly one page.  Page 0 is reserved as the *park page*:
    inactive slots keep an all-zero table row, so their parked decode
    writes land there and their (masked, discarded) gathers read from
    there — the table never holds an out-of-pool index.  The default
    pool size (1 park + slots x max_blocks) matches the contiguous
    layout's capacity; pass `num_pages` to serve under memory pressure.
    """

    PARK = 0

    def __init__(self, slots: int, max_len: int, page_size: int,
                 num_pages: int | None = None):
        self.page_size = page_size
        self.max_blocks = -(-max_len // page_size)
        self.num_pages = (1 + slots * self.max_blocks
                          if num_pages is None else num_pages)
        self.allocator = BlockAllocator(self.num_pages, reserved=1)
        self.block_tables = np.zeros((slots, self.max_blocks), np.int32)

    def alloc(self, owner, n: int) -> list[int] | None:
        return self.allocator.alloc(owner, n)

    def free(self, owner) -> list[int]:
        return self.allocator.free(owner)

    def assign(self, slot: int, pages: list[int]) -> None:
        row = np.zeros(self.max_blocks, np.int32)
        row[: len(pages)] = pages
        self.block_tables[slot] = row

    def release(self, slot: int) -> None:
        self.block_tables[slot] = self.PARK


class TorchEngine:
    """The model half of the server: weights, the batched cache, two steps.

    Owns the cache (slots x max_len) and exposes what the scheduler needs:

      * prefill_step(slot, tokens, pos) — one prefill work unit.  In
        ``chunked`` mode this is `Model.prefill_into` over a C-wide window
        and returns the window's last-token logits.  In ``decode`` mode
        (the baseline) it is ONE prompt token pushed through the
        whole-batch decode step, logits discarded.
      * decode_step(tokens, pos, active) — one batched decode tick; every
        row at its own position, inactive rows parked at max_len-1.

    ``prefill_calls`` / ``decode_calls`` count step dispatches.

    With ``paged=True`` the cache k/v are page pools (page size = C)
    addressed through ``self.pool``'s per-slot block tables; the scheduler
    drives the allocator and this engine hands the tables to both steps
    (copied to the device once per step).  ``num_pages`` sizes the pool
    (default: the contiguous layout's capacity plus the park page).  Paged
    mode requires chunked prefill: each prefill step fills one page.  With
    ``window=W`` every attention call is sliding-window; the scheduler
    parks and recycles out-of-window pages.

    Weights come from ``params`` — the JAX parameter tree as numpy arrays
    or torch tensors, full precision or with leaves in storage form
    (``{"q", "scale"}``), converted by `params_from_jax` — or are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device.  With
    ``quantize="int8"|"fp8"`` the KV cache is quantized (`Model`'s
    ``kv_quantize``) and so are the weights: drawn or full-precision ones
    through `quantize_tree`, and a tree in storage form must hold codes of
    that format.  ``device`` must be the container's: the engine never
    moves to another one.
    """

    def __init__(self, cfg, container, *, slots: int, max_len: int,
                 chunk: int = 16, prefill_mode: str = "chunked",
                 paged: bool = False, num_pages: int | None = None,
                 window: int | None = None, quantize: str | None = None,
                 device: str | torch.device = "cuda",
                 params: Mapping | None = None, seed: int = 0):
        if prefill_mode not in ("chunked", "decode"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if chunk < 1 or chunk > max_len:
            raise ValueError(f"chunk {chunk} outside [1, max_len={max_len}]")
        if paged and prefill_mode != "chunked":
            raise ValueError("paged cache requires prefill_mode='chunked'")
        if window is not None and window < 1:
            raise ValueError(f"sliding window of {window} tokens")
        if quantize == "none":
            quantize = None
        if quantize is not None and quantize not in ("int8", "fp8"):
            raise ValueError(f"quantize must be int8/fp8/none, got {quantize!r}")
        dev = torch.device(device)
        if dev.type != container.device.type or dev.index not in (None, container.device.index):
            raise ValueError(f"engine device {dev} is not the container's {container.device}")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk
        self.prefill_mode = prefill_mode
        self.paged = paged
        self.window = window
        self.quantize = quantize
        self.device = container.device
        self.model = Model(cfg, container.binding, device=self.device, kv_quantize=quantize)
        if params is None:
            self.model.init(torch.Generator(device=self.device).manual_seed(seed), quantize)
        else:
            self.load_params(params)
        self.pool = PagedPool(slots, max_len, chunk, num_pages) if paged else None
        if paged:
            self.cache = self.model.init_paged_cache(self.pool.num_pages, chunk, slots)
        else:
            self.cache = self.model.init_cache(slots, max_len)
        self.prefill_calls = 0
        self.decode_calls = 0

    def load_params(self, np_tree: Mapping) -> None:
        """Serve the weights of a JAX parameter tree (numpy or torch
        leaves; storage-form leaves bind the quantized paths).  Under
        ``quantize`` a full-precision tree is quantized first, and a tree
        in storage form must hold codes of that format."""
        if self.quantize is not None:
            np_tree = _in_storage_form(np_tree, self.quantize)
        self.model.load_params(params_from_jax(np_tree, self.cfg))

    # -- prefill ----------------------------------------------------------
    @property
    def prefill_unit(self) -> int:
        """Prompt tokens ingested per prefill_step call."""
        return self.chunk if self.prefill_mode == "chunked" else 1

    def prefill_step(self, slot: int, tokens: np.ndarray, pos: int):
        """Ingest one prefill unit into `slot` at cache position `pos`.

        tokens: (n,) int with 1 <= n <= prefill_unit.  Returns the logits
        (vocab,) of tokens[-1] in chunked mode, None in decode (baseline)
        mode.
        """
        n = int(tokens.shape[0])
        if self.prefill_mode == "chunked":
            buf = np.zeros((1, self.chunk), np.int32)
            buf[0, :n] = tokens
            row = self.pool.block_tables[slot] if self.paged else None
            logits, self.cache = self.model.prefill_into(buf, self.cache, int(slot), int(pos), n,
                                                         block_row=row, window=self.window)
            self.prefill_calls += 1
            return logits[0].cpu().numpy()
        if n != 1:
            raise ValueError(f"decode-mode prefill takes one token, got {n}")
        tok = np.zeros((self.slots, 1), np.int32)
        tok[slot, 0] = int(tokens[0])
        posv = np.full(self.slots, self.max_len - 1, np.int32)
        posv[slot] = pos
        act = np.zeros(self.slots, bool)
        act[slot] = True
        _, self.cache = self.model.decode(tok, self.cache, posv, act, window=self.window)
        self.decode_calls += 1
        return None

    # -- decode -----------------------------------------------------------
    def decode_step(self, tokens: np.ndarray, pos: np.ndarray,
                    active: np.ndarray) -> np.ndarray:
        """One batched decode tick.  tokens (slots, 1), pos (slots,),
        active (slots,) bool; returns (slots, vocab) logits (garbage on
        inactive rows)."""
        table = self.pool.block_tables if self.paged else None
        logits, self.cache = self.model.decode(tokens, self.cache, pos, active,
                                               block_tables=table, window=self.window)
        self.decode_calls += 1
        return logits.cpu().numpy()

    # -- KV handoff (the fleet's slot migration) --------------------------
    def export_slot(self, slot: int, n_tokens: int) -> tuple[dict, int]:
        """One slot's written pages out of the paged pools, as host numpy
        arrays (`Model.export_paged_slot`), and how many pages they are.
        ``n_tokens`` is the number of positions written so far.  The arrays
        import into a `JaxEngine` as they do into a `TorchEngine`."""
        if not self.paged:
            raise ValueError("slot export requires the paged cache")
        if n_tokens < 1:
            raise ValueError(f"export of {n_tokens} tokens")
        pages_used = -(-n_tokens // self.pool.page_size)
        pages = self.pool.block_tables[slot][:pages_used]
        return self.model.export_paged_slot(self.cache, pages, slot), pages_used

    def import_slot(self, slot: int, arrays: dict, pages_used: int) -> None:
        """Scatter a KV handoff into this engine's own pages: the first
        ``pages_used`` entries of the slot's block table, which the
        scheduler leased (`Scheduler.adopt`) before this call."""
        if not self.paged:
            raise ValueError("slot import requires the paged cache")
        pages = self.pool.block_tables[slot][:pages_used]
        self.cache = self.model.import_paged_slot(self.cache, arrays, pages, slot)


def _in_storage_form(tree: Mapping, fmt: str) -> Mapping:
    """`tree` with its weights in storage form of format `fmt`: a tree
    with no ``{"q", "scale"}`` leaf goes through `quantize_tree` (its
    leaves as torch tensors), one with such leaves is returned as it is
    when every code is of `fmt`'s dtype, and refused otherwise."""
    leaves = dict(tree_items(tree))
    codes = {path: leaf for path, leaf in leaves.items()
             if path.endswith("/q") and path[:-2] + "/scale" in leaves}
    if not codes:
        return quantize_tree(torch_tree(tree), fmt)
    want = str(storage_dtype(fmt)).removeprefix("torch.")
    wrong = sorted(path for path, leaf in codes.items()
                   if str(leaf.dtype).removeprefix("torch.") != want)
    if wrong:
        raise ValueError(f"quantize={fmt!r}: the tree's codes at {wrong[:3]} are not {want}")
    return tree


class Scheduler:
    """Continuous batching policy: pure python, deterministic, no jax.

    One `tick()` is the scheduling quantum:

      1. **admit** — pop FCFS from the queue into free slots (requests
         were budget-checked at submit; admission just assigns slots).
      2. **prefill** — run up to `interleave` prefill work units, FCFS
         across prefilling requests.  The interleave ratio is the
         latency knob: higher drains prompts faster (better TTFT under
         prefill backlog), lower keeps decode ticks flowing (better
         per-token latency for running requests).
      3. **decode** — one batched decode tick if anything is decoding.

    Admission control (at `submit`):
      * queue bounded at `queue_depth` — excess rejected (queue-full);
      * `max_new` clamped to `max_new_cap`;
      * **contiguous**: the prompt+generation budget must fit one slot's
        cache window: prompt_len + max_new <= max_len AND every chunk's
        C-wide write window stays in bounds (ceil(prompt_len/C)*C <=
        max_len — conservative: the whole window is reserved up front);
        the baseline path needs one extra slot for its duplicated last
        prompt token.  Unfit requests are rejected (too-long), never
        queued — a queued request is guaranteed servable.
      * **paged**: the budget is counted in *pages actually needed*
        (ceil(budget / page)); a request is rejected only when that can
        never be satisfied (more pages than the block table holds or
        than exist in the pool).  A satisfiable request that finds the
        pool momentarily exhausted *queues* — `_admit` allocates pages
        FCFS and stops at the first request the pool cannot serve yet,
        so it admits as soon as a completion frees pages.

    The clock is injected so tests can drive TTFT accounting with a
    deterministic fake; the engine is injected so policy tests need no
    compiled model at all.

    **Fleet mode** (repro.serving) runs one Scheduler per replica as
    that replica's *local* policy.  ``on_handoff`` turns a scheduler
    into a prefill-pool policy: when a request's prompt is fully
    ingested it emits the first token, then — instead of decoding —
    calls the hook (with the slot still held, so the fleet can export
    the pages), releases the slot/pages locally, and marks the request
    HANDOFF.  `adopt` is the decode-pool counterpart: place a
    handed-off request straight into a free slot with pages leased from
    THIS engine's allocator, no queue and no prefill.
    """

    def __init__(self, engine, *, queue_depth: int = 64,
                 max_new_cap: int = 1 << 30, interleave: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 on_handoff: Callable[[Request], None] | None = None):
        if on_handoff is not None and engine.prefill_mode != "chunked":
            raise ValueError("handoff (prefill-pool role) requires chunked "
                             "prefill: the final chunk's logits are the "
                             "first token the handoff carries")
        self.engine = engine
        self.paged = bool(getattr(engine, "paged", False))
        # sliding-window width (getattr: policy tests drive fakes that
        # predate the windowed engine)
        self.window = getattr(engine, "window", None)
        self.queue_depth = queue_depth
        self.max_new_cap = max_new_cap
        self.interleave = max(1, interleave)
        self.clock = clock
        self.on_handoff = on_handoff
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * engine.slots
        # sliding-window page recycling: physical pages whose logical
        # block fell out of the attention window, banked per request
        # (keyed by order) until the write head claims a new block
        self._spare: dict[int, list[int]] = {}
        self.rejected: dict[str, int] = {}
        self.submitted = 0
        self.completed = 0
        self.handed_off = 0
        self.adopted = 0
        self.peak_active = 0
        self.ticks = 0
        # (pages allocated, pages holding written tokens) per tick — the
        # fragmentation series the table7 --paged scoreboard reports and
        # consolidated_stats() aggregates
        self.page_samples: list[tuple[int, int]] = []

    # -- admission --------------------------------------------------------
    def _budget(self, prompt_len: int, max_new: int) -> int:
        """Highest cache position + 1 this request can touch."""
        c = self.engine.prefill_unit
        chunks_end = -(-prompt_len // c) * c       # last chunk's write window
        gen_end = prompt_len + max_new
        if self.engine.prefill_mode == "decode":
            gen_end += 1                           # baseline re-feeds last token
        return max(chunks_end, gen_end)

    def _pages_needed(self, prompt_len: int, max_new: int, *,
                      capped: bool = True) -> int:
        """Pages a request must lease up front.

        With a sliding window the footprint is *capped*: logical blocks
        wholly behind the window are parked as the write head advances
        and their physical pages re-mapped to the blocks ahead
        (`_slide_window`), so at most ceil(W/page)+1 pages — the blocks
        the window straddles plus the one being written — are ever live.
        This is what shrinks windowed admission from O(prompt+gen) to
        O(window).  `capped=False` gives the uncapped count (`adopt`
        needs it: a KV handoff scatters the full written prefix, so the
        adopting slot's table must map every written block up front).
        """
        page = self.engine.pool.page_size
        full = -(-self._budget(prompt_len, max_new) // page)
        w = self.window
        if capped and w is not None:
            return min(full, -(-w // page) + 1)
        return full

    def servable(self, prompt_len: int, max_new: int) -> bool:
        """Can this request EVER be served by this engine's geometry?
        (The admission budget check, independent of momentary load —
        the fleet router uses it against a template replica.)"""
        if prompt_len < 1:
            return False
        if self.paged:
            pool = self.engine.pool
            # the block table must index every logical block the budget
            # touches (the window caps leased pages, not logical extent)
            if (self._pages_needed(prompt_len, max_new, capped=False)
                    > pool.max_blocks):
                return False
            return (self._pages_needed(prompt_len, max_new)
                    <= pool.allocator.capacity)
        return self._budget(prompt_len, max_new) <= self.engine.max_len

    def submit(self, req: Request) -> bool:
        """Admission-checked enqueue; returns False (and records why)
        when the request is rejected."""
        self.submitted += 1
        req.max_new = min(req.max_new, self.max_new_cap)
        if not self.servable(req.prompt_len, req.max_new):
            self.rejected[REJECT_TOO_LONG] = self.rejected.get(REJECT_TOO_LONG, 0) + 1
            return False
        if len(self.queue) >= self.queue_depth:
            self.rejected[REJECT_QUEUE_FULL] = self.rejected.get(REJECT_QUEUE_FULL, 0) + 1
            return False
        if req.order < 0:
            # the fleet pre-assigns globally-unique FCFS orders (one
            # allocator may host slots from many submit counters); a
            # standalone scheduler numbers its own
            req.order = self.submitted
        req.submit_t = self.clock()
        req.state = QUEUED
        self.queue.append(req)
        return True

    def adopt(self, req: Request) -> bool:
        """Decode-pool side of a KV handoff: place a handed-off request
        straight into a free slot, leasing its remaining-budget pages
        from THIS engine's allocator (the handoff contents are scattered
        by the caller via ``engine.import_slot`` once this returns True).
        Returns False when no slot or no pages are available right now —
        the fleet keeps the artifact pending and retries, exactly like
        paged admission queues on pool exhaustion."""
        slot = next((s for s in range(self.engine.slots)
                     if self.active[s] is None), None)
        if slot is None:
            return False
        if self.paged:
            # uncapped even under a sliding window: import_slot scatters
            # the handoff's full written prefix, so every written block
            # needs a mapped page; _slide_window recycles from there
            pages = self.engine.pool.alloc(
                req.order,
                self._pages_needed(req.prompt_len, req.max_new, capped=False),
            )
            if pages is None:
                return False
            self.engine.pool.assign(slot, pages)
        req.slot = slot
        req.state = DECODING
        self.active[slot] = req
        self.adopted += 1
        self.peak_active = max(
            self.peak_active, sum(r is not None for r in self.active)
        )
        return True

    def _admit(self) -> None:
        for s in range(self.engine.slots):
            if not self.queue:
                break
            if self.active[s] is not None:
                continue
            if self.paged:
                # FCFS in pages: allocate head-of-line's pages or wait —
                # skipping ahead would starve long requests forever
                req = self.queue[0]
                pages = self.engine.pool.alloc(
                    req.order, self._pages_needed(req.prompt_len, req.max_new)
                )
                if pages is None:
                    break                          # out of pages: stay queued
                self.queue.popleft()
                self.engine.pool.assign(s, pages)
            else:
                req = self.queue.popleft()
            req.slot = s
            req.state = PREFILLING
            req.prefill_pos = 0
            self.active[s] = req

    # -- lifecycle helpers ------------------------------------------------
    def _emit(self, req: Request, token: int, out: list) -> None:
        if req.first_token_t is None:
            req.first_token_t = self.clock()
        req.tokens.append(token)
        out.append((req.rid, token))
        if len(req.tokens) >= req.max_new:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.state = DONE
        req.finish_t = self.clock()
        if self.paged:
            self._spare.pop(req.order, None)
            self.engine.pool.free(req.order)
            self.engine.pool.release(req.slot)
        self.active[req.slot] = None
        req.slot = None
        self.completed += 1

    def _handoff(self, req: Request) -> None:
        """Prefill-pool exit: hand the finished slot to the fleet (the
        hook exports the pages while the slot is still held), then
        release the local slot/pages — the artifact now carries the
        state, so this replica owes the request nothing further."""
        req.state = HANDOFF
        self.on_handoff(req)
        if self.paged:
            self._spare.pop(req.order, None)
            self.engine.pool.free(req.order)
            self.engine.pool.release(req.slot)
        self.active[req.slot] = None
        req.slot = None
        self.handed_off += 1

    def _slide_window(self, req: Request) -> None:
        """Sliding-window page recycling (paged + windowed engines only).

        A logical block whose last position can never be attended again
        ((j+1)*page <= head - W) is *dead*: its table entry is parked —
        the kernel's gather then reads the poison-inert park page and the
        window mask discards it — and its physical page is banked in the
        request's spare list.  The block the write head is about to enter
        is mapped from that bank.  Pages never return to the shared
        allocator mid-flight (another admission could snap them up and
        deadlock this request's next write); the lease cap in
        `_pages_needed` already priced the steady state, and everything
        goes back at `_finish`.  Repro note: live blocks are always the
        contiguous run [ (head-W)//page, head//page ], at most
        ceil(W/page)+1 of them — the lease cap.
        """
        pool = self.engine.pool
        w = self.window
        page = pool.page_size
        head = req.prefill_pos if req.state == PREFILLING else req.next_pos
        row = pool.block_tables[req.slot]
        spare = self._spare.setdefault(req.order, [])
        dead = max(0, head - w) // page
        spare.extend(int(p) for p in row[:dead] if p != pool.PARK)
        row[:dead] = pool.PARK
        nb = head // page                  # block the next write lands in
        if nb < pool.max_blocks and row[nb] == pool.PARK:
            # the lease cap guarantees a banked page is available here
            assert spare, "sliding-window lease underflow"
            row[nb] = spare.pop()

    # -- the quantum ------------------------------------------------------
    def tick(self) -> list[tuple[int, int]]:
        """Admit, prefill up to `interleave` units, one decode tick.
        Returns the (rid, token) pairs emitted this quantum."""
        self.ticks += 1
        self._admit()
        self.peak_active = max(
            self.peak_active, sum(r is not None for r in self.active)
        )
        out: list[tuple[int, int]] = []

        for _ in range(self.interleave):
            req = min(
                (r for r in self.active if r is not None and r.state == PREFILLING),
                key=lambda r: r.order, default=None,
            )
            if req is None:
                break
            if self.paged and self.window is not None:
                self._slide_window(req)
            n = min(self.engine.prefill_unit, req.prompt_len - req.prefill_pos)
            window = req.prompt[req.prefill_pos : req.prefill_pos + n]
            logits = self.engine.prefill_step(req.slot, window, req.prefill_pos)
            req.prefill_steps += 1
            req.prefill_pos += n
            if req.prefill_pos >= req.prompt_len:
                req.next_pos = req.prompt_len
                req.state = DECODING
                if logits is not None:
                    # chunked path: the final chunk's logits ARE the first
                    # token — no decode tick spent re-feeding the prompt
                    self._emit(req, int(np.argmax(logits)), out)
                if self.on_handoff is not None and not req.done:
                    # prefill-pool role: decode happens on another replica
                    self._handoff(req)

        decoding = [r for r in self.active if r is not None and r.state == DECODING]
        if decoding:
            if self.paged and self.window is not None:
                for r in decoding:
                    self._slide_window(r)
            tok = np.zeros((self.engine.slots, 1), np.int32)
            pos = np.full(self.engine.slots, self.engine.max_len - 1, np.int32)
            act = np.zeros(self.engine.slots, bool)
            for r in decoding:
                # baseline seeds from the re-fed last prompt token (its
                # prefill discarded the logits); chunked always has tokens
                tok[r.slot, 0] = r.tokens[-1] if r.tokens else int(r.prompt[-1])
                pos[r.slot] = r.next_pos
                act[r.slot] = True
            logits = self.engine.decode_step(tok, pos, act)
            for r in decoding:
                r.decode_steps += 1
                r.next_pos += 1
                self._emit(r, int(np.argmax(logits[r.slot])), out)
        if self.paged:
            page = self.engine.pool.page_size
            w = self.window
            used = 0
            for r in self.active:
                if r is None:
                    continue
                head = r.prefill_pos if r.state == PREFILLING else r.next_pos
                written = -(-head // page)
                if w is not None:
                    # recycled (out-of-window) blocks no longer hold
                    # readable tokens — count only the live window
                    written -= max(0, head - w) // page
                used += written
            self.page_samples.append((self.engine.pool.allocator.used, used))
        return out

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.active)

    def consolidated_stats(self) -> dict[str, float]:
        """The schema-pinned serving counters, pool occupancy included.

        Every key in SERVING_STATS_SCHEMA is always present (0 on the
        contiguous path), mirroring the dispatch layer's consolidated
        stats: printers iterate the schema, so a new counter cannot be
        silently dropped from any output, and the per-tick
        ``page_samples`` series — previously reachable only from the
        benchmark — aggregates here for every consumer.
        """
        samples = self.page_samples
        alloc_mean = (sum(a for a, _ in samples) / len(samples)
                      if samples else 0.0)
        written_mean = (sum(w for _, w in samples) / len(samples)
                        if samples else 0.0)
        stats: dict[str, float] = {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected-queue-full": self.rejected.get(REJECT_QUEUE_FULL, 0),
            "rejected-too-long": self.rejected.get(REJECT_TOO_LONG, 0),
            "handed-off": self.handed_off,
            "adopted": self.adopted,
            "peak-active": self.peak_active,
            "ticks": self.ticks,
            "pages-capacity": (self.engine.pool.allocator.capacity
                               if self.paged else 0),
            "pages-allocated-mean": alloc_mean,
            "pages-written-mean": written_mean,
            "pages-allocated-peak": (max((a for a, _ in samples), default=0)
                                     if self.paged else 0),
            "fragmentation-pct": (100.0 * (1.0 - written_mean / alloc_mean)
                                  if alloc_mean else 0.0),
        }
        assert set(stats) == SERVING_STATS_SCHEMA
        return stats


class Server:
    """Scheduler + TorchEngine + request log — what main() drives.
    `submit` admission-checks and records, `run` ticks until idle,
    `requests` holds every Request (accepted or not)."""

    def __init__(self, cfg, container, *, slots: int, max_len: int,
                 chunk: int = 16, prefill_mode: str = "chunked",
                 queue_depth: int = 64, max_new_cap: int = 1 << 30,
                 interleave: int = 2, paged: bool = False,
                 num_pages: int | None = None, window: int | None = None,
                 quantize: str | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: str | torch.device = "cuda",
                 params: Mapping | None = None, seed: int = 0):
        self.engine = TorchEngine(cfg, container, slots=slots, max_len=max_len,
                                  chunk=chunk, prefill_mode=prefill_mode,
                                  paged=paged, num_pages=num_pages,
                                  window=window, quantize=quantize,
                                  device=device, params=params, seed=seed)
        self.scheduler = Scheduler(self.engine, queue_depth=queue_depth,
                                   max_new_cap=max_new_cap,
                                   interleave=interleave, clock=clock)
        self.requests: list[Request] = []

    def submit(self, req: Request) -> bool:
        self.requests.append(req)
        return self.scheduler.submit(req)

    def step(self) -> list[tuple[int, int]]:
        return self.scheduler.tick()

    def run(self, max_ticks: int = 1 << 20) -> None:
        """Tick until every accepted request completes."""
        ticks = 0
        while not self.scheduler.idle:
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("scheduler failed to drain (livelock?)")


def serves_reduced(device: str) -> bool:
    """Whether `main` serves the reduced test config: on the CPU it does;
    on the card it serves the published widths, the only ones its kernels
    are built for (head_dim 64 or 128)."""
    return torch.device(device).type == "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to serve: the Hopper card named by "
                         "REPRO_VISIBLE_DEVICES (default 0), or the CPU")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk width C: each prefill step ingests C "
                         "prompt tokens into one slot")
    ap.add_argument("--prefill-mode", choices=("chunked", "decode"), default="chunked",
                    help="'decode' replays the old prefill-by-decode loop "
                         "(O(prompt_len) whole-batch ticks) as a baseline")
    ap.add_argument("--paged", action="store_true",
                    help="page the KV cache (page size = --chunk) with "
                         "per-slot block tables; admission budgets in pages "
                         "actually needed (requires chunked prefill)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size incl. the reserved park page "
                         "(default: 1 + slots * ceil(max_len/chunk), the "
                         "contiguous layout's capacity)")
    ap.add_argument("--window", type=int, default=None, metavar="W",
                    help="sliding-window attention: every token attends "
                         "only its trailing W keys; with --paged, "
                         "out-of-window pages are parked and recycled, "
                         "capping each request's admission footprint at "
                         "ceil(W/chunk)+1 pages")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="admission control: submits beyond this queue depth "
                         "are rejected, not buffered")
    ap.add_argument("--interleave", type=int, default=2,
                    help="prefill work units per scheduler tick")
    ap.add_argument("--quantize", choices=("none", "int8", "fp8"), default="none",
                    help="serve int8/fp8 weights (quantize_tree's {q, scale} "
                         "leaves, per-channel scales) over a KV cache of the same "
                         "format: 1 byte an element, one static scale a slot")
    args = ap.parse_args(argv)

    reduced = serves_reduced(args.device)
    runtime = Runtime()
    container = runtime.deploy(make_bundle(args.arch, reduced=reduced), device=args.device)
    print(container.describe())
    cfg = get_config(args.arch).reduced() if reduced else get_config(args.arch)
    server = Server(cfg, container, slots=args.slots, max_len=args.max_len,
                    chunk=args.chunk, prefill_mode=args.prefill_mode,
                    queue_depth=args.queue_depth, interleave=args.interleave,
                    paged=args.paged, num_pages=args.num_pages, window=args.window,
                    quantize=args.quantize, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(2, 6)).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    server.run()
    dt = time.time() - t0

    done = [r for r in server.requests if r.done]
    total_tokens = sum(len(r.tokens) for r in done)
    ttfts = sorted(r.ttft for r in done)
    print(f"served {len(done)} requests / {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"prefill_mode={args.prefill_mode}, quantize={args.quantize}, "
          f"device={container.device})")
    if ttfts:
        print(f"TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f}ms "
              f"max {ttfts[-1] * 1e3:.1f}ms | steps: "
              f"prefill={server.engine.prefill_calls} "
              f"decode={server.engine.decode_calls}")
    if server.scheduler.rejected:
        print("rejected: " + " ".join(
            f"{k}={v}" for k, v in sorted(server.scheduler.rejected.items())))
    if args.paged:
        pool = server.engine.pool
        stats = server.scheduler.consolidated_stats()
        print(f"paged pool: {pool.num_pages} pages x {pool.page_size} tokens "
              f"(park+{int(stats['pages-capacity'])}) | "
              f"peak_active={int(stats['peak-active'])} | "
              f"pages allocated/used mean "
              f"{stats['pages-allocated-mean']:.1f}"
              f"/{stats['pages-written-mean']:.1f} "
              f"(fragmentation {stats['fragmentation-pct']:.0f}%)")
    runtime.cleanup()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
