"""The port's replay buffer against ``nuzero_tpu.training.replay``.

The deterministic parts (``add_games`` with masked rows and ring overwrite,
``truncate_to_seq``, ``position_weights``, ``gather``) must agree exactly on
the same numpy inputs.  The random parts draw from another generator than
JAX's, so they are held to the behaviours ``tests/test_replay.py`` checks
on the JAX buffer: valid positions only, late-heavy favours recent games,
unique draws without replacement, a complete epoch permutation with the
valid positions first, and the game-type filter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.training import replay as jax_replay
from nuzero_tpu_torch.training import replay

D, A, L = 18, 9, 9


def _finished_np(n, start=0.0, length=5, batch=None, mask=None, game_type=None):
    """Arrays of a FinishedGames batch whose first ``n`` rows are real."""
    b = batch or n
    states = np.zeros((b, L, D), np.float32)
    policy = np.zeros((b, L, A), np.float32)
    for i in range(b):
        states[i, :, 0] = start + i  # tags the game
        states[i, :, 1] = np.arange(L)  # tags the position
        policy[i, :, i % A] = 1.0
    m = np.zeros(b, bool)
    m[:n] = True
    lengths = np.full(b, length, np.int32) if np.isscalar(length) else np.asarray(length, np.int32)
    return dict(
        states=states, policy=policy,
        final_value=(start + np.arange(b)).astype(np.float32),
        length=lengths,
        game_type=np.zeros(b, np.int32) if game_type is None else np.asarray(game_type, np.int32),
        mask=m if mask is None else np.asarray(mask),
    )


def _both(arrays):
    return (jax_replay.FinishedGames(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            replay.FinishedGames(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _assert_same(tbuf, jbuf):
    for f in ("states", "policy", "value", "length", "game_type", "seq"):
        np.testing.assert_array_equal(getattr(tbuf, f).numpy(), np.asarray(getattr(jbuf, f)),
                                      err_msg=f)
    assert tbuf.ptr == int(jbuf.ptr) and tbuf.games_added == int(jbuf.games_added)
    assert tbuf.num_games == int(jbuf.num_games)
    assert int(tbuf.num_positions) == int(jbuf.num_positions)


def _fill(G, batches):
    jbuf = jax_replay.create_buffer(G, L, D, A)
    tbuf = replay.create_buffer(G, L, D, A, device="cpu")
    for arrays in batches:
        jf, tf = _both(arrays)
        jbuf = jax_replay.add_games(jbuf, jf)
        tbuf = replay.add_games(tbuf, tf)
        _assert_same(tbuf, jbuf)
    return tbuf, jbuf


# Batches of finished games: masked rows in the middle, variable lengths,
# and enough games to overwrite the ring (capacity 5).
BATCHES = [
    _finished_np(2, start=0, length=[3, 9]),
    _finished_np(0, start=10, batch=3, mask=[True, False, True], length=[4, 2, 7]),
    _finished_np(3, start=20, batch=4, length=[1, 5, 9, 6]),
    _finished_np(0, start=30, batch=2, mask=[False, False]),
    _finished_np(2, start=40, length=[8, 2], game_type=[1, 0]),
]


def test_add_games_matches_jax():
    """Masked rows dropped, values over the valid positions only, the ring
    overwriting its oldest slots, after every batch."""
    _fill(5, BATCHES)


@pytest.mark.parametrize("seq_limit", [0, 2, 4, 7, 9])
def test_truncate_to_seq_matches_jax(seq_limit):
    tbuf, jbuf = _fill(5, BATCHES)
    _assert_same(replay.truncate_to_seq(tbuf, seq_limit),
                 jax_replay.truncate_to_seq(jbuf, seq_limit))


@pytest.mark.parametrize("late_heavy", [False, True])
def test_position_weights_match_jax(late_heavy):
    for batches in (BATCHES[:2], BATCHES):
        tbuf, jbuf = _fill(5, batches)
        np.testing.assert_array_equal(
            replay.position_weights(tbuf, late_heavy).numpy(),
            np.asarray(jax_replay.position_weights(jbuf, late_heavy)))


def test_gather_matches_jax():
    tbuf, jbuf = _fill(5, BATCHES)
    idx = np.random.default_rng(0).integers(0, 5 * L, 40)
    for got, want in zip(replay.gather(tbuf, torch.from_numpy(idx)),
                         jax_replay.gather(jbuf, jnp.asarray(idx, jnp.int32))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _buffer(G, *batches):
    buf = replay.create_buffer(G, L, D, A, device="cpu")
    for arrays in batches:
        buf = replay.add_games(buf, _both(arrays)[1])
    return buf


def test_sample_returns_valid_positions():
    buf = _buffer(8, _finished_np(3, length=4))
    states, policy, value, _ = replay.sample(buf, torch.Generator().manual_seed(0), 64)
    assert states.shape == (64, D)
    assert (policy.sum(-1) > 0.99).all()  # a recorded one-hot, never an empty row
    assert (states[:, 1] < 4).all()  # inside each game's length


def test_late_heavy_favours_recent_games():
    buf = _buffer(8, *[_finished_np(1, start=i) for i in range(6)])
    per_game = replay.position_weights(buf, late_heavy=True).sum(1)
    filled = buf.length > 0
    seqs, ws = buf.seq[filled], per_game[filled]
    assert torch.equal(ws[torch.argsort(seqs)], torch.sort(ws).values)
    assert ws.max() > ws.min()
    states, *_ = replay.sample(buf, torch.Generator().manual_seed(0), 4000, late_heavy=True)
    counts = torch.bincount(states[:, 0].long(), minlength=6)
    assert counts[5] > counts[0]


def test_sample_without_replacement_unique():
    buf = _buffer(4, _finished_np(4, length=9))  # 36 valid positions
    states, *_ = replay.sample(buf, torch.Generator().manual_seed(1), 20,
                               with_replacement=False)
    assert len(torch.unique(states, dim=0)) == 20


def test_epoch_permutation_valid_first_and_complete():
    buf = _buffer(4, _finished_np(3, length=5))
    n_valid = int(buf.num_positions)
    perm = replay.epoch_permutation(buf, torch.Generator().manual_seed(0))
    assert sorted(perm.tolist()) == list(range(4 * L))
    valid = {g * L + p for g in range(4) for p in range(int(buf.length[g]))}
    assert set(perm[:n_valid].tolist()) == valid
    perm2 = replay.epoch_permutation(buf, torch.Generator().manual_seed(1))
    assert perm[:n_valid].tolist() != perm2[:n_valid].tolist()


def test_game_type_filter():
    buf = _buffer(4, _finished_np(4, length=5, game_type=[0, 1, 0, 1]))
    perm = replay.epoch_permutation(buf, torch.Generator().manual_seed(0), game_type=1)
    n_t1 = int(torch.where(buf.game_type == 1, buf.length, 0).sum())
    assert set((perm[:n_t1] // L).tolist()) == {1, 3}
    _, _, _, gt = replay.gather(buf, perm[:n_t1])
    assert (gt == 1).all()
    _, _, _, gt = replay.sample(buf, torch.Generator().manual_seed(0), 64, game_type=0)
    assert (gt == 0).all()
