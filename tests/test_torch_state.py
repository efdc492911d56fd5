"""The port's checkpoints (``runtime/state.py``) in the reference's ``.npz``
format: a file written by the port loads through
``jsdr_tpu.runtime.state.load_state`` and a file written by the reference
loads through the port's, leaf for leaf byte-equal, for the Session's
``{stage name: BpskState}`` trees; and the port makes the reference's
refusals, with its messages."""

import jax
import numpy as np
import pytest
import torch

from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.runtime import state as JS
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.runtime import state as TS


def _random_jax_states(seed):
    """Two stages' states with every leaf random (numpy leaves in the
    reference's BpskState structure)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return rng.standard_normal(x.shape).astype(x.dtype)
        return rng.integers(-100, 100, x.shape).astype(x.dtype)

    cfg = JB.BpskConfig()
    return {"telemetry": jax.tree.map(fill, JB.bpsk_init_batch(cfg, 3)),
            "spectrum-telemetry": jax.tree.map(fill,
                                               JB.bpsk_init_batch(cfg, 2))}


def _port_like():
    cfg = TB.BpskConfig()
    return {"telemetry": TB.bpsk_init_batch(cfg, 3, "cpu"),
            "spectrum-telemetry": TB.bpsk_init_batch(cfg, 2, "cpu")}


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_leaf_order_is_jax_tree_flatten_order():
    js = _random_jax_states(1)
    port = {k: TB.state_from_numpy(v, "cpu") for k, v in js.items()}
    _assert_leaves_equal(TS.tree_leaves(port), jax.tree.leaves(js))
    assert TS.tree_leaves({"b": None, "a": (1, [2, None, 3])}) == [1, 2, 3]


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    js = _random_jax_states(2)
    f = tmp_path / "ref.npz"
    JS.save_state(f, js, meta={"rate": 96000, "n_demods": 3})
    got = TS.load_state(f, _port_like(),
                        expect_meta={"rate": 96000, "n_demods": 3})
    assert list(got) == ["spectrum-telemetry", "telemetry"]
    st = got["telemetry"]
    assert isinstance(st, TB.BpskState) and isinstance(st.ds_tail, CF)
    assert isinstance(st.timing, TB.TimingState)
    assert st.ring.device.type == "cpu"
    _assert_leaves_equal(TS.tree_leaves(got), jax.tree.leaves(js))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    js = _random_jax_states(3)
    port = {k: TB.state_from_numpy(v, "cpu") for k, v in js.items()}
    f = tmp_path / "port.npz"
    TS.save_state(f, port, meta={"rate": 96000})
    like = {"telemetry": JB.bpsk_init_batch(JB.BpskConfig(), 3),
            "spectrum-telemetry": JB.bpsk_init_batch(JB.BpskConfig(), 2)}
    got = JS.load_state(f, like, expect_meta={"rate": 96000})
    assert isinstance(got["telemetry"], JB.BpskState)
    _assert_leaves_equal(jax.tree.leaves(got), jax.tree.leaves(js))
    # and back through the port: a round trip changes nothing
    back = TS.load_state(f, _port_like())
    _assert_leaves_equal(TS.tree_leaves(back), TS.tree_leaves(port))


def test_refusals_match_the_reference(tmp_path):
    cfg = TB.BpskConfig()
    f = tmp_path / "st.npz"
    TS.save_state(f, TB.bpsk_init_batch(cfg, 4, "cpu"), meta={"rate": 96000})
    # wrong n_streams -> leaf shape mismatch, named in the error
    with pytest.raises(ValueError, match="current configuration"):
        TS.load_state(f, TB.bpsk_init_batch(cfg, 2, "cpu"))
    # wrong declared rate -> meta mismatch
    with pytest.raises(ValueError, match="rate"):
        TS.load_state(f, TB.bpsk_init_batch(cfg, 4, "cpu"),
                      expect_meta={"rate": 192000})
    # meta key the writer never recorded -> refused
    with pytest.raises(ValueError, match="lacks"):
        TS.load_state(f, TB.bpsk_init_batch(cfg, 4, "cpu"),
                      expect_meta={"max_hits": 4})
    # a different stage layout -> leaf-count mismatch
    with pytest.raises(ValueError, match="leaves"):
        TS.load_state(f, {"telemetry": TB.bpsk_init(cfg, "cpu"),
                          "demod": {"x": torch.zeros(3)}})
    # another format version, and an unversioned (pre-round-5) file
    leaves = {f"leaf_{i}": TS._host(x) for i, x in
              enumerate(TS.tree_leaves(TB.bpsk_init_batch(cfg, 4, "cpu")))}
    v1, legacy = tmp_path / "v1.npz", tmp_path / "legacy.npz"
    np.savez(v1, state_version=1, n_leaves=len(leaves), **leaves)
    np.savez(legacy, n_leaves=len(leaves), **leaves)
    with pytest.raises(ValueError, match="format v1"):
        TS.load_state(v1, TB.bpsk_init_batch(cfg, 4, "cpu"))
    with pytest.raises(ValueError, match="MIGRATION"):
        TS.load_state(legacy, TB.bpsk_init_batch(cfg, 4, "cpu"))
    # the same messages as the reference's, word for word
    for path, like, meta in ((f, {"rate": 192000}, True), (v1, None, False)):
        msgs = []
        for mod, init in ((TS, lambda: TB.bpsk_init_batch(cfg, 4, "cpu")),
                          (JS, lambda: JB.bpsk_init_batch(JB.BpskConfig(),
                                                          4))):
            with pytest.raises(ValueError) as e:
                mod.load_state(path, init(),
                               expect_meta=like if meta else None)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # a matching configuration loads
    st = TS.load_state(f, TB.bpsk_init_batch(cfg, 4, "cpu"),
                       expect_meta={"rate": 96000})
    assert tuple(st.ring.shape) == (4, 5199)
