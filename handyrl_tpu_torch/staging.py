"""Device-resident episode staging: the replay buffer lives on the card.

The counterpart of ``handyrl_tpu.staging``.  Each finished episode is
decompressed and columnarized ONCE, then copied into a ring of
fixed-shape tensors on the training device (observations in the
compact wire dtype: bfloat16 or uint8).  Every training batch is built
on the device by one gather; the host contributes no per-step data at
all: the draw (triangular recency over the ring, uniform window start,
uniform seat) runs on the device from a ``torch.Generator`` seeded by
the config seed, reading the ring's fill state from a device tensor.
Masks, padding, value bootstrap and progress — every ``make_batch``
semantic — are recomputed from the episode lengths in the gather
(tests/test_torch_staging.py holds the gather equal to the JAX twin's
on injected indices).

Storage layout: per-step channels are TWO-dimensional
``(CAP * T_max + _RUN_ROUND, features)`` tensors (slot-major time,
trailing dims flattened), so a window fetch is ONE ``index_select`` of
rows ``slot * T_max + t``.  Per-slot channels (outcome, lengths) are
``(CAP + 1, ...)``.  The extra slot and the ``_RUN_ROUND``-row stripe
past the ring are scratch that the padding of a batched append lands
in and no gather reads: every append has one of a few fixed shapes.

Episodes longer than ``T_max`` re-lay the ring (:meth:`_grow`, T_max
doubles); the byte budget ``device_replay_mb`` caps the ring's
capacity, counting the tensors' logical bytes.

Thread contract: appends and draws run on one thread (the trainer
thread calls ``ingest`` between update steps); the learner's server
thread only enqueues raw episodes into ``pending`` (under a lock).
The ring is written in place by ``index_copy_``.
"""

import threading
from collections import deque

import numpy as np
import torch

from .batch import ILLEGAL, _build_columnar, load_block, to_bf16_bits
from .device import resolve_device
from .utils.tree import tree_flatten, tree_map, tree_unflatten

_GROW_ROUND = 32   # T_max granularity; growth doubles
# episode uploads pad to _GROW_ROUND-row buckets and each append batch
# pads its TOTAL rows to _RUN_ROUND, the padding landing in the
# scratch stripe past the ring
_RUN_ROUND = 256
_MAX_RUN = 8       # episodes per append (one scatter per channel)
_PER_SLOT = ("outcome", "ep_len", "ep_total")
_STEP_CHANNELS = {  # name: (per-player width, storage dtype)
    "prob": (1, torch.float32), "act": (1, torch.int32),
    "value": (1, torch.float32), "reward": (1, torch.float32),
    "return": (1, torch.float32), "tmask": (1, torch.bool),
    "omask": (1, torch.bool),
}
_OBS_STORE = {"bfloat16": torch.bfloat16, "uint8": torch.uint8}


def _decompress_episode(ep):
    """Full-episode columnar arrays from the wire format (runs once per
    episode at ingest)."""
    moments = [m for blob in ep["moment"] for m in load_block(blob)]
    col = _build_columnar(moments)
    col["outcome"] = np.asarray(
        [ep["outcome"][p] for p in col["players"]],
        np.float32).reshape(-1, 1)
    col["steps"] = ep["steps"]
    return col


def _round_up(n, k=_GROW_ROUND):
    return ((n + k - 1) // k) * k


def _upload(array, dtype, device):
    """A host array into a tensor of ``dtype`` on ``device``; bfloat16
    arrives as its uint16 bit pattern and is viewed, not converted."""
    array = np.ascontiguousarray(array)
    if dtype == torch.bfloat16:
        return torch.from_numpy(array.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(array).to(device, dtype)


class DeviceReplay:
    """Ring buffer of episodes on the training device + batch gather.

    ``mode`` mirrors ``make_batch``'s player selection:
      turn — turn-based training: acting channels gather the turn
             player (P_in=1), value channels keep all players
      seat — simultaneous games: ONE random seat per draw, all channels
      all  — observation mode: all players, all channels
    """

    def __init__(self, cfg, capacity, max_bytes, device, max_steps_hint=0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(capacity)   # may shrink to fit max_bytes
        self.max_bytes = int(max_bytes)
        self.forward_steps = cfg["forward_steps"]
        self.burn_in = cfg.get("burn_in_steps", 0) or 0
        self.t_win = self.burn_in + self.forward_steps
        if cfg["turn_based_training"]:
            self.mode = "all" if cfg.get("observation") else "turn"
        else:
            self.mode = "seat"
        self.obs_store = _OBS_STORE.get(cfg.get("transfer_dtype") or "",
                                        torch.float32)
        self.compute_dtype = getattr(
            torch, cfg.get("compute_dtype") or "bfloat16")

        self.t_max = _round_up(max(max_steps_hint, self.t_win))
        self.buffers = None
        self.num_players = None
        self.ep_len = None         # host mirror of the episode lengths
        self.write_ptr = 0         # next slot (FIFO ring)
        self.size = 0              # filled slots
        self.episodes_seen = 0
        self.growths = 0

        # server thread -> trainer thread handoff
        self.pending = deque()
        self.pending_cap = 512
        self.dropped = 0
        self._lock = threading.Lock()
        self._state_dirty = True   # ring changed since last device_state

    def device_state(self):
        """Device int64 ``[size, oldest]``, the ring's fill state the
        on-device draw reads.  Uploaded only after an append or a
        growth moved the ring (``state_dirty``)."""
        self._state_dirty = False
        return torch.tensor([self.size, self.oldest], dtype=torch.int64,
                            device=self.device)

    @property
    def state_dirty(self):
        return self._state_dirty

    # -- ingest -------------------------------------------------------

    def offer(self, episodes):
        """Server-thread side: queue raw episodes for the trainer
        thread.  Bounded: a stalled trainer sheds the OLDEST pending
        episodes (counted in ``dropped``)."""
        with self._lock:
            self.pending.extend(e for e in episodes if e is not None)
            while len(self.pending) > self.pending_cap:
                self.pending.popleft()
                self.dropped += 1

    def ingest(self, max_episodes=64, batch=_MAX_RUN):
        """Trainer-thread only: move pending episodes into the ring, up
        to ``batch`` episodes per scatter."""
        batch = min(batch, _MAX_RUN)
        if self.buffers is None:
            # size T_max from everything already waiting
            with self._lock:
                if self.pending:
                    self.t_max = max(self.t_max, _round_up(
                        max(e["steps"] for e in self.pending)))
        done = 0
        while done < max_episodes:
            with self._lock:
                eps = [self.pending.popleft()
                       for _ in range(min(batch, len(self.pending)))]
            if not eps:
                return
            cols = [_decompress_episode(ep) for ep in eps]
            done += len(cols)
            need = max(len(c["turn_idx"]) for c in cols)
            if self.buffers is None:
                if need > self.t_max:
                    self.t_max = _round_up(need)
                self._init_buffers(cols[0])
            elif need > self.t_max:
                self._grow(_round_up(max(need, self.t_max * 2)))
            while cols:
                # never more episodes than ring slots in one scatter
                run = cols[:self.capacity]
                self._append_run(run)
                del cols[:len(run)]

    def warm_start(self, episodes, chunk=64):
        """Restore a replayed backlog (the episode WAL) straight into
        the ring on the CALLER's thread, ``chunk`` episodes at a time
        through the batched ``ingest`` (a chunk never reaches the
        ``pending`` cap, so nothing is shed).  Must run before
        the trainer thread starts: the ring has one writer thread.
        Returns the number of episodes staged."""
        count = 0
        episodes = [e for e in episodes if e is not None]
        for i in range(0, len(episodes), chunk):
            part = episodes[i:i + chunk]
            self.offer(part)
            self.ingest(max_episodes=len(part))
            count += len(part)
        return count

    # -- buffer management -------------------------------------------

    def _step_bytes(self, col):
        """Bytes one episode step occupies in the ring."""
        P = len(col["players"])
        A = col["amask"].shape[-1]
        obs = 0
        for leaf in tree_flatten(col["obs"])[0]:
            width = int(np.prod(leaf.shape[1:]))  # (T, P, ...) -> P*...
            item = (self.obs_store.itemsize
                    if np.issubdtype(leaf.dtype, np.floating)
                    else leaf.dtype.itemsize)
            obs += width * item
        chans = sum(P * w * dt.itemsize
                    for w, dt in _STEP_CHANNELS.values())
        return obs + chans + P * A + 4  # + amask bool, turn_idx int32

    @staticmethod
    def _slot_const_bytes(P):
        return 4 * P + 8  # outcome, ep_len, ep_total

    def _init_buffers(self, col):
        P = self.num_players = len(col["players"])
        A = col["amask"].shape[-1]
        self._per_step_bytes = self._step_bytes(col)
        per_slot = (self._per_step_bytes * self.t_max
                    + self._slot_const_bytes(P))
        fit = max(1, self.max_bytes // per_slot)
        if fit < self.capacity:
            print(f"device replay: {self.capacity} episodes at "
                  f"~{per_slot / 1e6:.2f} MB each exceed the "
                  f"{self.max_bytes >> 20} MiB budget; ring capped at "
                  f"{fit} (raise device_replay_mb to widen)")
            self.capacity = int(fit)
        flat = self.capacity * self.t_max + _RUN_ROUND
        obs_leaves, self.obs_treedef = tree_flatten(col["obs"])
        self.obs_shapes = [leaf.shape[1:] for leaf in obs_leaves]
        self.obs_dtypes = [
            self.obs_store if np.issubdtype(leaf.dtype, np.floating)
            else torch.from_numpy(leaf[:0]).dtype for leaf in obs_leaves]
        self.shapes = {k: (P, w) for k, (w, _) in _STEP_CHANNELS.items()}
        self.shapes["amask"] = (P, A)

        def zeros(rows, shape, dtype):
            width = int(np.prod(shape)) if shape else 1
            return torch.zeros((rows, width), dtype=dtype,
                               device=self.device)

        buffers = {k: zeros(flat, self.shapes[k], dt)
                   for k, (_, dt) in _STEP_CHANNELS.items()}
        buffers["obs"] = tree_unflatten(self.obs_treedef, [
            zeros(flat, shape, dt)
            for shape, dt in zip(self.obs_shapes, self.obs_dtypes)])
        buffers["amask"] = zeros(flat, (P, A), torch.bool)
        buffers["turn_idx"] = zeros(flat, (), torch.int32)
        buffers["outcome"] = torch.zeros(
            (self.capacity + 1, P, 1), dtype=torch.float32,
            device=self.device)
        for key in ("ep_len", "ep_total"):
            buffers[key] = torch.zeros(self.capacity + 1,
                                       dtype=torch.int64,
                                       device=self.device)
        self.buffers = buffers
        self.ep_len = np.zeros(self.capacity, np.int64)
        print(f"device replay: ring of {self.capacity} episodes x "
              f"{self.t_max} steps on {self.device} "
              f"({self.nbytes / 2 ** 20:.1f} MiB)")

    @property
    def nbytes(self):
        leaves = tree_flatten(self.buffers)[0] if self.buffers else []
        return sum(t.numel() * t.element_size() for t in leaves)

    def _pad_episode(self, col, rows):
        """Columnar episode -> ``rows`` host rows per step channel in
        the storage dtypes (``rows`` is the episode's bucket-rounded
        length, not T_max)."""
        T = len(col["turn_idx"])
        pad = rows - T

        def padt(a, value=0):
            a = np.ascontiguousarray(a).reshape(T, -1)  # 2D storage
            if pad == 0:
                return a
            return np.pad(a, [(0, pad), (0, 0)], constant_values=value)

        def obs_store(a):
            if not np.issubdtype(a.dtype, np.floating):
                return a
            if self.obs_store == torch.uint8:
                q = a.astype(np.uint8)
                if not np.array_equal(q.astype(a.dtype), a):
                    raise ValueError(
                        "transfer_dtype 'uint8' requires integer-"
                        "valued observations; use 'bfloat16'")
                return q
            if self.obs_store == torch.bfloat16:
                return to_bf16_bits(a)
            return a.astype(np.float32)

        return {
            "obs": tree_map(lambda a: padt(obs_store(a)), col["obs"]),
            "prob": padt(col["prob"].astype(np.float32)),
            "act": padt(col["act"].astype(np.int32)),
            "amask": padt(col["amask"] != 0, True),
            "value": padt(col["value"].astype(np.float32)),
            "reward": padt(col["reward"].astype(np.float32)),
            "return": padt(col["return"].astype(np.float32)),
            "tmask": padt(col["tmask"] != 0),
            "omask": padt(col["omask"] != 0),
            "turn_idx": padt(col["turn_idx"].astype(np.int32)),
            "outcome": col["outcome"][None],  # (1, P, 1): one ring slot
            "ep_len": np.asarray([T], np.int64),
            "ep_total": np.asarray([col["steps"]], np.int64),
        }

    def _append_run(self, cols):
        """Write ``len(cols) <= _MAX_RUN`` episodes with one
        ``index_copy_`` per channel.  Rows pad to _RUN_ROUND into the
        scratch stripe, slots to _MAX_RUN into the scratch slot."""
        k = len(cols)
        lens = [len(c["turn_idx"]) for c in cols]
        rows = [_round_up(t) for t in lens]
        eps = [self._pad_episode(c, r) for c, r in zip(cols, rows)]
        slots = [(self.write_ptr + i) % self.capacity for i in range(k)]
        pad = -sum(rows) % _RUN_ROUND
        scratch = self.capacity * self.t_max
        flat_idx = np.concatenate(
            [s * self.t_max + np.arange(r) for s, r in zip(slots, rows)]
            + [scratch + np.arange(pad)])
        slot_idx = np.asarray(slots + [self.capacity] * (_MAX_RUN - k))
        flat_idx_t = torch.from_numpy(flat_idx).to(self.device)
        slot_idx_t = torch.from_numpy(slot_idx).to(self.device)

        def cat(arrs, fill):
            out = np.concatenate(arrs)
            if fill:
                out = np.concatenate(
                    [out, np.zeros((fill,) + out.shape[1:], out.dtype)])
            return out

        for key, buf in self.buffers.items():
            per_slot = key in _PER_SLOT
            idx = slot_idx_t if per_slot else flat_idx_t
            fill = _MAX_RUN - k if per_slot else pad
            if key == "obs":
                parts = [tree_flatten(e["obs"])[0] for e in eps]
                targets = tree_flatten(buf)[0]
                for i, target in enumerate(targets):
                    src = cat([p[i] for p in parts], fill)
                    target.index_copy_(
                        0, idx, _upload(src, target.dtype, self.device))
            else:
                src = cat([e[key] for e in eps], fill)
                buf.index_copy_(0, idx, _upload(src, buf.dtype, self.device))
        for s, t in zip(slots, lens):
            self.ep_len[s] = t
        self.write_ptr = (self.write_ptr + k) % self.capacity
        self.size = min(self.size + k, self.capacity)
        self.episodes_seen += k
        self._state_dirty = True

    def _grow(self, new_t_max):
        """A longer episode than T_max arrived: re-lay the ring with a
        larger T_max on the device.  The byte budget holds: if wider
        slots no longer fit, the ring shrinks, keeping the NEWEST
        episodes."""
        old_t, cap = self.t_max, self.capacity
        new_cap = min(cap, max(1, self.max_bytes // (
            self._per_step_bytes * new_t_max
            + self._slot_const_bytes(self.num_players))))
        print(f"device replay: growing T_max {old_t} -> {new_t_max}"
              + (f", ring {cap} -> {new_cap} (byte budget)"
                 if new_cap < cap else ""))
        n = self.size
        order = [(self.write_ptr - n + i) % cap for i in range(n)]
        keep = np.asarray(order[-new_cap:] if n > new_cap else order,
                          np.int64)
        kept = len(keep)
        flat_keep = torch.from_numpy(
            (keep[:, None] * old_t + np.arange(old_t)[None]).reshape(-1)
        ).to(self.device)
        keep_t = torch.from_numpy(keep).to(self.device)

        def relayout(key, a):
            if key in _PER_SLOT:
                out = a.new_zeros((new_cap + 1,) + a.shape[1:])
                out[:kept] = a.index_select(0, keep_t)
                return out
            out = a.new_zeros((new_cap * new_t_max + _RUN_ROUND,)
                              + a.shape[1:])
            ring = out[:new_cap * new_t_max].view(
                (new_cap, new_t_max) + a.shape[1:])
            ring[:kept, :old_t] = a.index_select(0, flat_keep).view(
                (kept, old_t) + a.shape[1:])
            return out

        self.buffers = {
            key: (tree_map(lambda a: relayout(key, a), buf)
                  if key == "obs" else relayout(key, buf))
            for key, buf in self.buffers.items()}
        new_len = np.zeros(new_cap, np.int64)
        new_len[:kept] = self.ep_len[keep]
        self.ep_len = new_len
        self.size = kept
        self.write_ptr = kept % new_cap
        self.capacity = new_cap
        self.t_max = new_t_max
        self.growths += 1
        self._state_dirty = True

    # -- sampling -----------------------------------------------------

    @property
    def oldest(self):
        """Ring slot of the oldest live episode (host mirror)."""
        return (self.write_ptr - self.size) % self.capacity

    def draw(self, state, generator, batch_size):
        """``(slots, tstarts, seats)`` drawn on the device: triangular
        recency over the ring — P(idx) = (idx+1)/S, S = n(n+1)/2, the
        host batcher's accept loop in closed form — then a uniform
        window start and (seat mode) a uniform seat.  ``state`` is
        :meth:`device_state`; nothing is read back to the host."""
        size, oldest = state[0], state[1]
        n = size.to(torch.float32)
        u = torch.rand(batch_size, generator=generator, device=self.device)
        idx = torch.floor(
            (torch.sqrt(1.0 + 4.0 * u * n * (n + 1)) - 3.0) / 2.0
        ).long() + 1
        idx = torch.minimum(idx.clamp(min=0), size - 1)
        slots = (oldest + idx) % self.capacity
        cands = 1 + (self.buffers["ep_len"][slots]
                     - self.forward_steps).clamp(min=0)
        tstarts = torch.floor(
            torch.rand(batch_size, generator=generator, device=self.device)
            * cands).long()
        if self.mode == "seat":
            seats = torch.randint(0, self.num_players, (batch_size,),
                                  generator=generator, device=self.device)
        else:
            seats = torch.zeros(batch_size, dtype=torch.int64,
                                device=self.device)
        return slots, tstarts, seats

    def gather(self, slots, tstarts, seats):
        """The training batch for explicit ``(slots, tstarts, seats)``
        (int64 device tensors): all of ``make_batch``'s semantics."""
        buffers = self.buffers
        t_max, t_win = self.t_max, self.t_win
        lens = buffers["ep_len"][slots]                  # (B,)
        totals = buffers["ep_total"][slots]

        # window positions g in episode time; validity from lengths
        g = (tstarts - self.burn_in)[:, None] + torch.arange(
            t_win, device=self.device)                  # (B,T)
        valid = (g >= 0) & (g < lens[:, None])
        after = g >= lens[:, None]       # past the terminal step
        flat_idx = (slots[:, None] * t_max + g.clamp(0, t_max - 1)
                    ).reshape(-1)

        def fetch(buf, shape):
            # 2D ring rows -> logical (B, T, *shape) window
            return buf.index_select(0, flat_idx).view(
                g.shape + tuple(shape))

        def mask_t(x, pad_value, m=valid):
            return torch.where(m.view(m.shape + (1,) * (x.ndim - 2)), x,
                               pad_value)

        turn = fetch(buffers["turn_idx"], ()).long()     # (B,T)
        obs_leaves = [fetch(buf, shape) for buf, shape in zip(
            tree_flatten(buffers["obs"])[0], self.obs_shapes)]
        ch = {k: fetch(buffers[k], self.shapes[k])
              for k in list(_STEP_CHANNELS) + ["amask"]}
        outcome = buffers["outcome"][slots]              # (B,P,1)

        def select_players(x, idx):
            # (B,T,P,...) -> (B,T,1,...) by per-(row,step) player index
            return torch.take_along_dim(
                x, idx.view(idx.shape + (1,) * (x.ndim - 2)), dim=2)

        if self.mode == "turn":
            def acting(x):
                return select_players(x, turn)
        elif self.mode == "seat":
            seat_bt = seats[:, None].expand(turn.shape)

            def acting(x):
                return select_players(x, seat_bt)

            # seat mode selects ONE player for every channel
            for k in ("value", "reward", "return", "tmask", "omask"):
                ch[k] = acting(ch[k])
            outcome = torch.take_along_dim(outcome, seats[:, None, None],
                                           dim=1)
        else:
            def acting(x):
                return x

        def obs_out(a):
            sel = acting(a)
            if sel.is_floating_point() or sel.dtype == torch.uint8:
                sel = sel.to(self.compute_dtype)
            return mask_t(sel, 0)

        return {
            "observation": tree_unflatten(
                self.obs_treedef, [obs_out(a) for a in obs_leaves]),
            "selected_prob": mask_t(acting(ch["prob"]), 1.0),
            "action": mask_t(acting(ch["act"]), 0),
            "action_mask": mask_t(acting(ch["amask"]), True).to(
                torch.float32) * float(ILLEGAL),
            "value": torch.where(after[..., None, None], outcome[:, None],
                                 mask_t(ch["value"], 0.0)),
            "reward": mask_t(ch["reward"], 0.0),
            "return": mask_t(ch["return"], 0.0),
            "outcome": outcome[:, None],                 # (B,1,P,1)
            "episode_mask": valid[..., None, None].to(torch.float32),
            "turn_mask": mask_t(ch["tmask"], False).to(torch.float32),
            "observation_mask": mask_t(ch["omask"], False).to(
                torch.float32),
            "progress": torch.where(
                valid, g.to(torch.float32)
                / totals[:, None].to(torch.float32), 1.0)[..., None],
        }


def make_replay_update_step(replay, update_step, batch_size, seed=0,
                            share=None):
    """One training step from the ring: on-device draw -> gather ->
    ``update_step`` (an :class:`..ops.update.UpdateStep`, or the
    sharded step of :mod:`..parallel.update`, whose collectives then
    run inside).  The draw's generator lives on the ring's device,
    seeded from the config seed, so a steady-state step uploads nothing
    and reads nothing back: ``step(state) -> metrics`` with ``state``
    the ring's :meth:`DeviceReplay.device_state`.  Under a rank mesh
    ``batch_size`` is this rank's rows, and ``share`` (if given) maps
    the gathered rows to the ones the step takes (the dp group's, under
    sp or tp)."""
    generator = torch.Generator(device=replay.device)
    generator.manual_seed(int(seed))

    def step(state):
        slots, tstarts, seats = replay.draw(state, generator, batch_size)
        batch = replay.gather(slots, tstarts, seats)
        return update_step(batch if share is None else share(batch))

    step.generator = generator
    return step
