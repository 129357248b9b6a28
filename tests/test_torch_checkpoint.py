"""Port parity: checkpoints on disk, and the train loop's resume.

A checkpoint written by the JAX package restores bitwise in the port and
the other way round (bf16, f32 and int8 ``QTensor`` leaves; the port
keeps bf16 as its uint16 bits, as the JAX package does). The port's
train loop resumes from its own checkpoints bitwise. Delta checkpoints
(a ledger slice on a full base) are held in ``test_torch_fleet.py``,
where a fleet run makes the ledger.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.int8 import QTensor as JQ  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import zo  # noqa: E402
from repro_torch.core.elastic import TrainState, make_elastic_step  # noqa: E402
from repro_torch.core.int8 import QTensor  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.train_loop import LoopConfig, run  # noqa: E402


def _jax_tree():
    k = jax.random.key(3)
    return {
        "emb": (jax.random.normal(k, (5, 7)) * 3).astype(jnp.bfloat16),
        "blk": {"w": jax.random.normal(jax.random.fold_in(k, 1), (4, 3)),
                "b": jnp.zeros((3,), jnp.float32)},
        "fc": {"w": JQ(jax.random.randint(jax.random.fold_in(k, 2), (6, 2),
                                          -127, 128).astype(jnp.int8),
                       jnp.int32(-5))},
    }


def _port_tree(jt):
    """The same tree in the port (bf16 stays bf16, QTensors exact)."""
    p = params_from_jax(jax.tree.map(np.asarray, jt), "cpu")
    p["emb"] = p["emb"].to(torch.bfloat16)
    return p


def _tmap(fn, params):
    """fn over every tensor, a QTensor's two included."""
    return zo.map_with_path(
        lambda _p, x: QTensor(*map(fn, x)) if isinstance(x, QTensor)
        else fn(x), params)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _assert_same(port, jt):
    jflat = jax.tree_util.tree_flatten_with_path(jt)[0]
    pflat = ckpt.flatten_with_keys(port)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [k for k, _ in pflat]
    for (path, a), (_, b) in zip(jflat, pflat):
        a, b = _as_np(a), _as_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_paths_are_jax_keystr_order():
    jt = _jax_tree()
    flat = ckpt.flatten_with_keys(_port_tree(jt))
    assert [k for k, _ in flat] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert "['fc']['w'].data" in dict(flat)


def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path):
    jt = _jax_tree()
    jckpt.save(tmp_path, 7, jt)
    template = _tmap(torch.zeros_like, _port_tree(jt))
    got, step = ckpt.restore(tmp_path, template)
    assert step == 7
    assert isinstance(got["fc"]["w"], QTensor)
    assert got["emb"].dtype == torch.bfloat16
    _assert_same(got, jt)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    jt = _jax_tree()
    ckpt.save(tmp_path / "port", 7, _port_tree(jt))
    jckpt.save(tmp_path / "jax", 7, jt)
    got, step = jckpt.restore(tmp_path / "port",
                              jax.tree.map(jnp.zeros_like, jt))
    assert step == 7
    _assert_same(_port_tree(jt), got)
    # the same manifest (but for the wall-clock stamp)
    mp, mj = (json.loads((tmp_path / d / "step_00000007" / "manifest.json")
                         .read_text()) for d in ("port", "jax"))
    for k in ("keys", "shapes", "dtypes", "mode", "step"):
        assert mp[k] == mj[k], k


def test_async_keeps_the_newest_and_ignores_partial(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    p = {"w": torch.arange(6.0)}
    for s in (1, 2, 3):
        saver.save(s, _tmap(lambda t, s=s: t + s, p))
    saver.wait()
    assert sorted(d.name for d in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000003"]
    # a crash between COMMIT and the rename leaves a .tmp dir: ignored
    tmp = tmp_path / "step_00000009.tmp"
    tmp.mkdir()
    (tmp / "COMMIT").write_text("ok")
    assert ckpt.latest_step(tmp_path) == 3
    got, step = ckpt.restore(tmp_path, p)
    assert step == 3 and torch.equal(got["w"], torch.arange(6.0) + 3)


def _quadratic(probes=1):
    g = torch.Generator().manual_seed(0)
    params = {"w": {"w": torch.randn(6, 6, generator=g) * 0.3}}
    batch = {"x": torch.randn(16, 6, generator=g),
             "y": torch.randn(16, 6, generator=g)}

    def loss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"]["w"] - b["y"]))

    lane = LaneConfig(lane="full_zo", learning_rate=0.05, zo_eps=1e-3,
                      zo_num_probes=probes)
    step = make_elastic_step(loss, lane, partition_fn=lambda p: (dict(p), {}))
    return params, batch, step


def test_train_loop_resumes_bitwise(tmp_path):
    """4 steps straight == 2 steps, a checkpoint, then a restart that
    resumes at step 2; and a periodic checkpoint labelled N holds the
    params after N steps."""
    params, batch, step = _quadratic()

    def go(total, **kw):
        state = TrainState(_tmap(torch.clone, params), 0,
                           np.array([0, 9], np.uint32))
        return run(step, state, lambda t: batch,
                   LoopConfig(total_steps=total, log_every=0, **kw),
                   log=None).state

    straight = go(4)
    two = go(2, ckpt_dir=str(tmp_path / "a"))
    resumed = go(4, ckpt_dir=str(tmp_path / "a"))
    assert resumed.step == 4
    assert torch.equal(resumed.params["w"]["w"], straight.params["w"]["w"])
    go(4, ckpt_dir=str(tmp_path / "b"), ckpt_every=2)
    at2, s = ckpt.restore(tmp_path / "b", params, step=2)
    assert s == 2 and torch.equal(at2["w"]["w"], two.params["w"]["w"])


def test_train_loop_resume_keeps_the_probe_drop_stream(tmp_path):
    """With probes dropped at random, 2 steps, a checkpoint and a resume
    draw the masks of 4 steps straight, so the params end bitwise equal."""
    params, batch, step = _quadratic(probes=4)

    def go(total, **kw):
        state = TrainState(_tmap(torch.clone, params), 0,
                           np.array([0, 9], np.uint32))
        return run(step, state, lambda t: batch,
                   LoopConfig(total_steps=total, log_every=0, n_probes=4,
                              probe_drop_rate=0.5, **kw), log=None).state

    straight = go(4)
    go(2, ckpt_dir=str(tmp_path))
    resumed = go(4, ckpt_dir=str(tmp_path))
    assert resumed.step == 4
    assert torch.equal(resumed.params["w"]["w"], straight.params["w"]["w"])
