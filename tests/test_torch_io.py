"""Port parity: gwkit_torch.io reads gwkit's files with numpy alone and gets
the same arrays as gwkit's load_pytree / import_peft_dir (which use jax's
tree flattening and the safetensors package)."""
import json
import os

import numpy as np
import pytest
import torch

import jax

from gwkit.cli.inference import _load_gwkit_encoder as gw_load_encoder
from gwkit.models.adapters import import_peft_dir as gw_import_peft
from gwkit.models.heads import init_mlp_head
from gwkit.models.qadapter import QAdapterConfig as GwQCfg
from gwkit.models.qadapter import init_qadapter
from gwkit.models.whisper import config_for as gw_config_for
from gwkit.train.checkpoints import load_pytree
from gwkit_torch.cli.inference import _load_gwkit_encoder
from gwkit_torch.io import (Leaf, from_gwkit_numpy, import_peft_dir, load_pytree_npz,
                            read_safetensors, tree_leaves)
from gwkit_torch.models.heads import HEAD_WIDTHS, mlp_head_shapes
from gwkit_torch.models.qadapter import QAdapterConfig, param_shapes as qadapter_shapes
from gwkit_torch.models.whisper import config_for

CAP = os.path.join(os.path.dirname(__file__), "..", "artifacts", "capstone_r5")
RUN = os.path.join(CAP, "run")


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_capstone_encoder_loads_like_gwkit():
    """Leaf order is jax's (dict keys sorted): leaf_00000 is conv1.b and
    leaf_00021 is pos; ``pos`` is re-pinned to the serving geometry."""
    want = gw_load_encoder(os.path.join(CAP, "encoder_pretrained.npz"), "tiny",
                           gw_config_for("tiny", max_positions=256))
    got = _load_gwkit_encoder(os.path.join(CAP, "encoder_pretrained.npz"), "tiny",
                              config_for("tiny", max_positions=256))
    _assert_trees_equal(got, want)
    with np.load(os.path.join(CAP, "encoder_pretrained.npz")) as data:
        np.testing.assert_array_equal(got["conv1"]["b"], data["leaf_00000"])
        np.testing.assert_array_equal(got["layers"]["v"]["w"], data["leaf_00018"])


def test_capstone_head_and_qadapter_load_like_gwkit():
    head_like = init_mlp_head(jax.random.PRNGKey(0), 768, HEAD_WIDTHS["gwwhisper"], 2)
    want, _ = load_pytree(os.path.join(RUN, "best_dense_layers.npz"), head_like)
    got, _ = load_pytree_npz(os.path.join(RUN, "best_dense_layers.npz"),
                             mlp_head_shapes(768, HEAD_WIDTHS["gwwhisper"], 2))
    _assert_trees_equal(got, want)
    q_like = init_qadapter(jax.random.PRNGKey(0), GwQCfg(target_shape=(80, 512)))
    want, _ = load_pytree(os.path.join(RUN, "best_adapter.npz"), q_like)
    got, _ = load_pytree_npz(os.path.join(RUN, "best_adapter.npz"),
                             qadapter_shapes(QAdapterConfig(target_shape=(80, 512))))
    _assert_trees_equal(got, want)


def test_capstone_peft_dir_imports_like_gwkit():
    want, wcfg = gw_import_peft(os.path.join(RUN, "best_lora_weights"), n_layers=4)
    got, gcfg = import_peft_dir(os.path.join(RUN, "best_lora_weights"), n_layers=4)
    assert (gcfg.r, gcfg.alpha, gcfg.use_dora, gcfg.targets) == (wcfg.r, wcfg.alpha, wcfg.use_dora, wcfg.targets)
    assert gcfg.scaling == 4.0
    _assert_trees_equal(got, want)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    path = os.path.join(RUN, "best_lora_weights", "adapter_model.safetensors")
    want = load_file(path)
    got = read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    mixed = {"f64": np.arange(6.0).reshape(2, 3), "i32": np.arange(4, dtype=np.int32),
             "u8": np.arange(3, dtype=np.uint8), "f16": np.ones((2, 2), np.float16)}
    save_file(mixed, str(tmp_path / "m.safetensors"))
    got = read_safetensors(str(tmp_path / "m.safetensors"))
    for k, v in mixed.items():
        np.testing.assert_array_equal(got[k], v)


def test_safetensors_reader_widens_bf16(tmp_path):
    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    bits = (vals.view(np.uint32) >> 16).astype("<u2").tobytes()
    header = json.dumps({"w": {"dtype": "BF16", "shape": [3], "data_offsets": [0, 6]}}).encode()
    with open(tmp_path / "b.safetensors", "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + bits)
    np.testing.assert_array_equal(read_safetensors(str(tmp_path / "b.safetensors"))["w"], vals)


def test_load_pytree_checks_every_shape(tmp_path):
    np.savez(tmp_path / "t.npz", leaf_00000=np.zeros(3), leaf_00001=np.zeros((2, 2)))
    tree, _ = load_pytree_npz(str(tmp_path / "t.npz"), {"b": Leaf((2, 2)), "a": Leaf((3,))})
    assert tree["a"].shape == (3,) and tree["b"].shape == (2, 2)
    with pytest.raises(ValueError):
        load_pytree_npz(str(tmp_path / "t.npz"), {"a": Leaf((2, 2)), "b": Leaf((3,))})
    assert [tuple(x) for x in tree_leaves({"z": [Leaf((1,)), Leaf((2,))], "a": Leaf((3,))})] == \
        [(3,), (1,), (2,)]


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_hf_checkpoint_loads_like_gwkit(tmp_path, fmt):
    """An HF Whisper-tiny encoder file reads as gwkit reads it, and
    --hf-checkpoint puts it into the task with ``pos`` re-pinned."""
    from gwkit.models.hf_io import encoder_state_dict_from_params
    from gwkit.models.hf_io import load_hf_encoder as gw_load_hf
    from gwkit.models.whisper import init_encoder_params
    from gwkit_torch.cli.inference import load_task_from_components
    from gwkit_torch.models.hf_io import load_hf_encoder

    gw_cfg = gw_config_for("tiny")
    state = {"model.encoder." + k: np.array(v, np.float32) for k, v in
             encoder_state_dict_from_params(init_encoder_params(jax.random.PRNGKey(3), gw_cfg),
                                            gw_cfg).items()}
    path = str(tmp_path / f"encoder.{fmt}")
    if fmt == "safetensors":
        from safetensors.numpy import save_file
        save_file(state, path)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    _, want = gw_load_hf(path, size="tiny")
    _, got = load_hf_encoder(path, size="tiny")
    _assert_trees_equal(got, want)

    task = load_task_from_components(
        os.path.join(RUN, "best_lora_weights"), os.path.join(RUN, "best_dense_layers.npz"),
        os.path.join(RUN, "best_adapter.npz"), hf_checkpoint=path, target_shape=(80, 512),
        device="cpu")
    enc = task.params["encoder"]
    np.testing.assert_array_equal(enc["layers"][3]["fc2"]["w"].numpy(), want["layers"]["fc2"]["w"][3])
    assert tuple(enc["pos"].shape) == (256, 384)


def test_from_gwkit_numpy_unstacks_layers_and_adapters():
    enc = gw_load_encoder(os.path.join(CAP, "encoder_pretrained.npz"), "tiny",
                          gw_config_for("tiny", max_positions=256))
    ad, _ = gw_import_peft(os.path.join(RUN, "best_lora_weights"), n_layers=4)
    port = from_gwkit_numpy(jax.tree.map(np.asarray, enc), jax.tree.map(np.asarray, ad))
    assert len(port["encoder"]["layers"]) == 4 and len(port["adapters"]) == 4
    np.testing.assert_array_equal(port["encoder"]["layers"][2]["fc1"]["w"].numpy(),
                                  np.asarray(enc["layers"]["fc1"]["w"][2]))
    np.testing.assert_array_equal(port["adapters"][3]["o"]["m"].numpy(), np.asarray(ad["o"]["m"][3]))
    assert port["adapters"][0]["q"]["scaling"] == 4.0
    assert port["encoder"]["pos"].dtype == torch.float32
