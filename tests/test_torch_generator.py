"""The port's global generator (``paddle_tpu_torch/core/generator.py``)
against the JAX package's: key layout, ``fold_in``, the key sequence of
one seed, the state and its replay, the named streams and the package
root's RNG functions. Keys are compared word for word (exact)."""
import jax
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core import generator as jgen
from paddle_tpu_torch.core import generator as tgen
from paddle_tpu_torch.ops import threefry


def _words(jkey):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(jkey)))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 32 - 1, 2 ** 32,
                                  2 ** 32 + 5, 2 ** 40 + 3, -1, -5,
                                  -2 ** 31, 2 ** 62 + 3])
def test_key_layout_is_jax_random_key(seed):
    assert threefry.key(seed) == _words(jax.random.key(seed))


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 20 + 3, 2 ** 32 - 1])
def test_fold_in_is_jax_random_fold_in(data):
    for seed in (0, 3, 2 ** 33 + 1):
        got = threefry.fold_in(threefry.key(seed), data)
        assert got == _words(jax.random.fold_in(jax.random.key(seed),
                                                data))


def test_key_sequence_of_one_seed_equals_the_reference():
    """``next_key`` of a seeded generator: fold_in(key(seed), counter) for
    counter 0, 1, 2, ..., the reference's keys word for word."""
    jg, tg = jgen.Generator(11), tgen.Generator(11)
    for _ in range(6):
        assert tg.next_key() == _words(jg.next_key())
    assert tg.get_state() == jg.get_state() == (11, 6)
    jg.manual_seed(-3)
    tg.manual_seed(-3)
    assert [tg.next_key() for _ in range(3)] == \
        [_words(jg.next_key()) for _ in range(3)]
    assert tg.initial_seed() == jg.initial_seed() == -3


def test_seed_also_seeds_numpy_and_resets_the_tracker():
    for P in (jpaddle, tpaddle):
        P.seed(2 ** 33 + 7)
    a = np.random.rand(4)
    tpaddle.seed(2 ** 33 + 7)
    assert np.array_equal(np.random.rand(4), a)
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state() == \
        (2 ** 33 + 7, 0)
    assert tgen.get_rng_tracker().states() == {}


def test_state_round_trip_replays_the_stream():
    tpaddle.seed(5)
    tgen.active_key()
    st = tpaddle.get_rng_state()
    first = [tgen.active_key() for _ in range(3)]
    tpaddle.set_rng_state(st)
    assert [tgen.active_key() for _ in range(3)] == first
    jpaddle.seed(5)
    jgen.active_key()
    assert [_words(jgen.active_key()) for _ in range(3)] == first
    # the CUDA-named pair: one state per process, the same pair
    assert tpaddle.get_cuda_rng_state() == [tpaddle.get_rng_state()]
    tpaddle.set_cuda_rng_state([st])
    assert tpaddle.get_rng_state() == st


def test_named_streams_and_the_rng_state_context():
    """``RNGStatesTracker``: an added stream, a default stream seeded from
    the base seed and the name's stable hash, draws redirected inside
    ``rng_state(name)`` and back outside, states saved and restored: the
    reference's keys throughout."""
    out = {}
    for name, gen, conv in (("ref", jgen, _words),
                            ("port", tgen, lambda k: k)):
        gen.seed(9)
        tr = gen.get_rng_tracker()
        tr.add("model_parallel", 1234)
        with pytest.raises(ValueError, match="already exists"):
            tr.add("model_parallel", 1)
        keys = [conv(gen.active_key())]
        with gen.rng_state("model_parallel"):
            keys.append(conv(gen.active_key()))
            keys.append(conv(gen.active_key()))
        with tr.rng_state("data_parallel"):
            keys.append(conv(gen.active_key()))
        keys.append(conv(gen.active_key()))
        states = tr.states()
        with gen.rng_state("model_parallel"):
            after = conv(gen.active_key())
        tr.set_states(states)
        with gen.rng_state("model_parallel"):
            again = conv(gen.active_key())
        out[name] = (keys, states, after, again)
    assert out["port"] == out["ref"]
    keys, states, after, again = out["port"]
    assert after == again
    assert states["data_parallel"][0] == 9 + tgen._stable_hash(
        "data_parallel")


def test_wrap_replay_draws_the_same_keys_and_restores_the_state():
    g = tgen.Generator(4)
    g.next_key()
    state = g.get_state()
    fn = tgen.wrap_replay(lambda: [g.next_key(), g.next_key()], g, state)
    g.next_key()
    before = g.get_state()
    assert fn() == fn()
    assert g.get_state() == before
    jg = jgen.Generator(4)
    jg.next_key()
    assert fn() == [_words(jg.next_key()), _words(jg.next_key())]


def test_root_exports_match_the_reference():
    for name in ("seed", "Generator", "get_rng_state", "set_rng_state",
                 "get_cuda_rng_state", "set_cuda_rng_state"):
        assert callable(getattr(tpaddle, name)), name
        assert callable(getattr(jpaddle, name)), name
    assert isinstance(tpaddle.seed(1), tpaddle.Generator)
