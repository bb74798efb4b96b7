"""The port's checkpoints (torch's own format): a round trip, a leaf-shape
drift rejected with a message naming the leaf, and the format-version gate,
as ``tests/test_checkpoint.py`` asks of the JAX package's."""

import pytest
import torch

from nuzero_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint


def test_save_restore_roundtrip(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 7,
            "opt_state": {"count": 3, "mu": {"w": torch.ones(2, 3)}}}
    save_checkpoint(str(tmp_path), 7, tree)
    save_checkpoint(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(str(tmp_path), "auto", target=tree, device="cpu")
    assert step == 7 and restored["step"] == 7 and restored["opt_state"]["count"] == 3
    torch.testing.assert_close(restored["params"]["w"], tree["params"]["w"], rtol=0, atol=0)
    torch.testing.assert_close(restored["opt_state"]["mu"]["w"], torch.ones(2, 3))


def test_leaf_shape_drift_rejected_with_clear_message(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"buffer": {"states": torch.zeros(4, 10)}, "step": 1})
    target = {"buffer": {"states": torch.zeros(4, 12)}, "step": 0}
    with pytest.raises(ValueError, match=r"buffer/states.*\(4, 10\).*\(4, 12\)"):
        restore_checkpoint(str(tmp_path), 1, target=target, device="cpu")


def test_format_version_gate(tmp_path):
    tree = {"step": 1}
    save_checkpoint(str(tmp_path), 1, tree)
    (tmp_path / "FORMAT").write_text("0\n")
    with pytest.raises(ValueError, match="tree-layout version 0"):
        restore_checkpoint(str(tmp_path), 1, target=tree, device="cpu")


def test_no_checkpoint_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), "auto", device="cpu")
