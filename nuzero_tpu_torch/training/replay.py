"""Device-resident replay buffer with game-count windowing (counterpart of
``nuzero_tpu/training/replay.py``; behavioral target
``Training/ReplayBuffer.py``).

A ring of game slots ``[capacity_games, max_game_length, ...]`` on the
card: finished games from the lockstep self-play are written into ring
slots, and sampling flattens (slot, position) into one draw.  Positions
are stored as packed env states (``utils.packing``), and the samplers
rebuild observations from the drawn states with ``env.observe``, as the
JAX package does.  Value targets are the game's terminal value over its
positions.

Unlike the JAX buffer, this one is updated in place (``add_games`` writes
into the existing tensors rather than returning a copy of gigabytes).  As
in the JAX buffer, the ring pointer and the insertion count are 0-d device
tensors and ``add_games`` reads nothing on the host, so that self-play can
run ahead of the host; a checkpoint holds them as plain integers
(``to_tree``; ``ReplayBuffer(**tree)`` reads it back).  Random draws come from an explicit
``torch.Generator`` on the buffer's device.

Data parallel (``mesh``): each rank holds a ring of ``replay_window_size /
N`` games, written by its own self-play, and evicts its own oldest game.
This is a deviation from the JAX package, whose one ring sharded over the
mesh evicts the mesh's oldest game; reproducing that would take a
collective and a cross-rank copy after every move-batch.  Sampling keeps
the JAX semantics: the ranks' slots form one global slot space (rank r's
ring after rank r-1's), every rank draws the same global flat indices from
a generator seeded alike on every rank, over the all-gathered position
weights, and each rank contributes the rows it owns to one SUM all-reduce
that assembles the global batch on every rank (``gather``).  The
late-heavy ramp ranks a game within its own ring.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FinishedGames:
    """A batch of completed games emitted by one self-play step."""

    states: torch.Tensor  # f32[B, L, D] packed env states (utils.packing)
    policy: torch.Tensor  # f32[B, L, A]
    final_value: torch.Tensor  # f32[B] static terminal value
    length: torch.Tensor  # i32[B] positions recorded
    game_type: torch.Tensor  # i32[B]
    mask: torch.Tensor  # bool[B] True where the row is a real finished game


@dataclasses.dataclass
class ReplayBuffer:
    states: torch.Tensor  # f32[G, L, D] packed env states
    policy: torch.Tensor  # f32[G, L, A]
    value: torch.Tensor  # f32[G, L]
    length: torch.Tensor  # i32[G] 0 = empty slot
    game_type: torch.Tensor  # i32[G]
    seq: torch.Tensor  # i32[G] insertion sequence number (-1 = empty)
    ptr: torch.Tensor  # i64 0-d: next ring slot
    games_added: torch.Tensor  # i64 0-d: total games ever added

    def __post_init__(self):
        # Integers (a checkpoint's, truncate_to_seq's) become device tensors.
        for name in ("ptr", "games_added"):
            value = getattr(self, name)
            if not isinstance(value, torch.Tensor):
                setattr(self, name, torch.tensor(int(value), device=self.length.device))

    @property
    def capacity(self) -> int:
        return self.length.shape[0]

    @property
    def num_games(self) -> int:
        """Games held; reads the insertion count on the host."""
        return min(int(self.games_added), self.capacity)

    @property
    def num_positions(self) -> torch.Tensor:
        return self.length.sum()


def create_buffer(
    capacity_games: int,
    max_game_length: int,
    state_dim: int,
    num_actions: int,
    device="cuda",
) -> ReplayBuffer:
    """``state_dim``: width of the packed-state vectors."""
    G, L = capacity_games, max_game_length

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayBuffer(
        states=zeros(G, L, state_dim),
        policy=zeros(G, L, num_actions),
        value=zeros(G, L),
        length=zeros(G, dtype=torch.int32),
        game_type=zeros(G, dtype=torch.int32),
        seq=torch.full((G,), -1, dtype=torch.int32, device=device),
        ptr=0,
        games_added=0,
    )


def to_tree(buffer: ReplayBuffer) -> dict:
    """The buffer as a checkpoint's dict, the ring pointer and insertion
    count as plain integers (reads them on the host)."""
    tree = {f.name: getattr(buffer, f.name) for f in dataclasses.fields(buffer)}
    tree["ptr"], tree["games_added"] = int(buffer.ptr), int(buffer.games_added)
    return tree


def add_games(buffer: ReplayBuffer, finished: FinishedGames) -> ReplayBuffer:
    """Write the real rows of ``finished`` (``mask``) into the next ring
    slots, in row order; masked-out rows are dropped, and of more real rows
    than the ring holds only the last ``capacity`` stay.  In place, with no
    host read (the JAX buffer's masked scatter: a row's slot follows from
    its rank among the real rows, by ``cumsum``); returns the buffer.

    Every row writes, so that no count is needed: a row that is not kept
    writes the last kept row's data to that row's slot, or, when no row is
    kept, the slot's own content back; no slot is written two different
    values."""
    G, L = buffer.capacity, buffer.states.shape[1]
    B = finished.mask.shape[0]
    dev = buffer.length.device
    m = finished.mask
    rank = torch.cumsum(m.to(torch.int64), 0) - 1  # among the real rows
    n = rank[-1] + 1
    kept = m & (rank >= n - G)
    rows = torch.arange(B, device=dev)
    last = torch.argmax(torch.where(kept, rows, -1))  # 0 when none is kept
    src = torch.where(kept, rows, last)
    any_kept = kept[last]
    slot = (buffer.ptr + rank[src]) % G

    def put(table, values):
        # values [B, ...] of the rows ``src``; all rows share one slot when
        # none is kept, and that slot keeps its content.
        table[slot] = torch.where(any_kept, values, table[slot[:1]])

    length = finished.length[src]
    pos_valid = torch.arange(L, device=dev)[None, :] < length[:, None]
    put(buffer.states, finished.states[src])
    put(buffer.policy, finished.policy[src])
    put(buffer.value, torch.where(pos_valid, finished.final_value[src][:, None], 0.0))
    put(buffer.length, length.to(torch.int32))
    put(buffer.game_type, finished.game_type[src].to(torch.int32))
    put(buffer.seq, (buffer.games_added + rank[src]).to(torch.int32))
    buffer.ptr.copy_((buffer.ptr + n) % G)
    buffer.games_added.add_(n)
    return buffer


def truncate_to_seq(buffer: ReplayBuffer, seq_limit: int) -> ReplayBuffer:
    """The buffer as it was just before insertion ``seq_limit``: games
    inserted at or after it are dropped (their slots empty; older games they
    overwrote cannot be recovered), and the insertion count and ring pointer
    are reset to ``seq_limit``.  Returns a new buffer sharing the position
    tensors."""
    keep = (buffer.seq >= 0) & (buffer.seq < seq_limit)
    return dataclasses.replace(
        buffer,
        length=torch.where(keep, buffer.length, 0),
        seq=torch.where(keep, buffer.seq, -1),
        game_type=torch.where(keep, buffer.game_type, 0),
        games_added=buffer.games_added.clamp(max=seq_limit),
        ptr=seq_limit % buffer.capacity,
    )


def _valid(buffer: ReplayBuffer) -> torch.Tensor:
    L = buffer.value.shape[1]
    return torch.arange(L, device=buffer.length.device)[None, :] < buffer.length[:, None]


def position_weights(buffer: ReplayBuffer, late_heavy: bool) -> torch.Tensor:
    """f32[G, L] unnormalized sampling weights over valid positions.

    ``late_heavy`` is the reference's linear recency ramp
    (``AlphaZero.py:779-792``): weight = 0.25 + 0.5 * rank, with rank the
    game's normalized insertion order in (0, 1]."""
    valid = _valid(buffer)
    if not late_heavy:
        return valid.to(torch.float32)
    num_games = buffer.games_added.clamp(max=buffer.capacity)
    num = num_games.clamp(min=1).to(torch.float32)
    oldest = buffer.games_added - num_games  # seq of the oldest retained
    rank = (buffer.seq - oldest + 1).to(torch.float32) / num
    variation = 0.5
    w = (1.0 - variation) / 2.0 + variation * rank
    return torch.where(valid, w[:, None], 0.0)


def num_positions(buffer: ReplayBuffer, mesh=None, game_type=None) -> int:
    """Valid positions held (of ``game_type`` where given), over every rank's
    ring with a mesh; reads the count on the host."""
    n = buffer.length if game_type is None else torch.where(
        buffer.game_type == game_type, buffer.length, 0)
    n = n.sum().to(torch.int64).reshape(1)
    return int(n[0] if mesh is None else mesh.all_reduce(n)[0])


def epoch_permutation(buffer: ReplayBuffer, rng: torch.Generator, game_type=None, mesh=None):
    """i64[G*L] flat position indices, every valid position first in
    uniform-random order (invalid slots after): slicing the first
    ``n_batches * batch_size`` visits each valid position at most once.
    ``game_type`` restricts validity to one type's positions.  With a mesh
    the indices run over the global slot space (every rank's ring), the
    same on every rank."""
    valid = _valid(buffer)
    if game_type is not None:
        valid = valid & (buffer.game_type == game_type)[:, None]
    if mesh is not None:
        valid = mesh.all_gather(valid.to(torch.uint8)).bool()
    valid = valid.reshape(-1)
    key = torch.rand(valid.shape, generator=rng, device=valid.device)
    key = key + torch.where(valid, 0.0, 2.0)
    return torch.argsort(key, stable=True)


def gather(buffer: ReplayBuffer, flat_idx: torch.Tensor, mesh=None):
    """Positions by flat (game, position) index -> (states [N, D], policy
    [N, A], value [N], game_type [N]).  With a mesh the indices are global
    and every rank gets every row: each fills the rows it owns, zeros the
    rest, and one SUM all-reduce of the rows packed in one f32 buffer adds
    them up (a row and zeros: exact)."""
    L = buffer.value.shape[1]
    mine = None
    if mesh is not None:
        mine, local = mesh.owned(flat_idx, buffer.capacity * L)
        flat_idx = torch.where(mine, local, 0)
    gi, pi = flat_idx // L, flat_idx % L
    rows = (buffer.states[gi, pi], buffer.policy[gi, pi], buffer.value[gi, pi],
            buffer.game_type[gi])
    if mesh is None:
        return rows
    widths = [r[0].numel() for r in rows]
    packed = torch.cat([r.reshape(len(flat_idx), -1).float() for r in rows], dim=1)
    packed = mesh.all_reduce(torch.where(mine[:, None], packed, 0.0))
    states, policy, value, game_type = packed.split(widths, dim=1)
    return (states, policy, value[:, 0],
            game_type[:, 0].to(buffer.game_type.dtype))


def sample(
    buffer: ReplayBuffer,
    rng: torch.Generator,
    batch_size: int,
    *,
    late_heavy: bool = False,
    with_replacement: bool = True,
    game_type=None,
    mesh=None,
):
    """A training batch of positions -> (states [B, D] packed, policy
    [B, A], value [B], game_type [B]).  With replacement a categorical draw
    over the weights; without, Gumbel top-k.  ``game_type`` restricts the
    draw to one game type's positions.  With a mesh the draw runs over the
    ranks' all-gathered weights and every rank gets the global batch."""
    w = position_weights(buffer, late_heavy)
    if game_type is not None:
        w = w * (buffer.game_type == game_type)[:, None]
    if mesh is not None:
        w = mesh.all_gather(w)
    w = w.reshape(-1)
    if with_replacement:
        flat = torch.multinomial(w, batch_size, replacement=True, generator=rng)
    else:
        logw = torch.where(w > 0, torch.log(w.clamp(min=1e-30)), float("-inf"))
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(w.shape, generator=rng, device=w.device).clamp(min=tiny)
        flat = torch.topk(logw - torch.log(-torch.log(u)), batch_size).indices
    return gather(buffer, flat, mesh)
