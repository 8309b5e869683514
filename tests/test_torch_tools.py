"""The port's user tools, model summary and FLOP count against fr_tpu's on
the same files and seeded inputs: pack_dataset and fd_processing byte for
byte, convert_bcolz over a rootdir written with the port's compress_chunk,
embed on fr_tpu's embed-tool setup (ResNet18 at 32 px, 5 PNGs; bf16 per-row
cosine >= 0.99, PERF.md §2's bf16 tolerance; f32 max-abs <= 1e-4; a .pth of
the same weights gives the .npz's bits), model_summary's totals, and
encoder_forward_flops within 1% of fr_tpu's count_flops at full width."""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fr_tpu import configs as jax_configs
from fr_tpu.ckpt.checkpoint import export_encoder
from fr_tpu.models import build_encoder as jax_build_encoder
from fr_tpu.tools import convert_bcolz as jax_convert_bcolz
from fr_tpu.tools import embed as jax_embed
from fr_tpu.tools import fd_processing as jax_fd
from fr_tpu.tools import pack_dataset as jax_pack
from fr_tpu.train.task import pfc_config_from_conf as jax_pfc_config
from fr_tpu.utils.flops import count_flops
from fr_tpu.utils.summary import model_summary as jax_model_summary
from fr_tpu_torch import configs
from fr_tpu_torch.data import bcolz_reader
from fr_tpu_torch.data.synthetic import write_synthetic_folder
from fr_tpu_torch.models import build_encoder
from fr_tpu_torch.tools import convert_bcolz, embed, fd_processing
from fr_tpu_torch.tools import pack_dataset
from fr_tpu_torch.train.task import FaceRecognitionTask, pfc_config_from_conf
from fr_tpu_torch.utils.flops import encoder_forward_flops
from fr_tpu_torch.utils.jax_import import load_encoder_npz
from fr_tpu_torch.utils.summary import model_summary
from fr_tpu_torch.utils.torch_export import export_encoder_pth
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_eval_data import _write_rootdir_genuine

cv2 = pytest.importorskip("cv2")


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_pack_dataset_is_byte_equal_to_fr_tpu(tmp_path, capsys):
    write_synthetic_folder(str(tmp_path / "src"), n_classes=3, per_class=4,
                           img_size=24)
    jax_pack.main(["--src", str(tmp_path / "src"), "--dst",
                   str(tmp_path / "ref"), "--img_size", "16"])
    pack_dataset.main(["--src", str(tmp_path / "src"), "--dst",
                       str(tmp_path / "ours"), "--img_size", "16"])
    assert "packed 12 images into" in capsys.readouterr().out
    ours, ref = _tree_bytes(tmp_path / "ours"), _tree_bytes(tmp_path / "ref")
    assert sorted(ours) == ["classes.json", "images.npy", "labels.npy"]
    assert ours == ref


@pytest.mark.skipif(not bcolz_reader.blosc_available(),
                    reason="libblosc not present")
def test_convert_bcolz_equals_fr_tpu(tmp_path):
    """A 10-item (N, 3, 8, 8) f32 rootdir in chunks of 4 and its list file:
    the same <dst>.npy and <dst>_list.npy from both tools."""
    arr = np.random.default_rng(3).standard_normal(
        (10, 3, 8, 8)).astype(np.float32)
    src = tmp_path / "val" / "lfw"
    _write_rootdir_genuine(src, arr, chunklen=4)
    np.save(str(src) + "_list.npy", np.arange(5) % 2 == 0)
    assert convert_bcolz.main(["--src", str(src), "--dst",
                               str(tmp_path / "ours" / "lfw")]) == 0
    assert jax_convert_bcolz.main(["--src", str(src), "--dst",
                                   str(tmp_path / "ref" / "lfw")]) == 0
    for suffix in (".npy", "_list.npy"):
        ours = (tmp_path / "ours" / f"lfw{suffix}").read_bytes()
        assert ours == (tmp_path / "ref" / f"lfw{suffix}").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "ours" / "lfw.npy"), arr)


@pytest.mark.parametrize("detector", ["center", "haar"])
def test_fd_processing_is_byte_equal_to_fr_tpu(tmp_path, detector):
    """Non-square JPEGs and one unreadable file under two class dirs, in two
    identical trees: the same crops in imgs_fd/ and the same stats (haar
    falls back to the centre crop where cv2 has no objdetect or no
    cascade, on both sides alike)."""
    for side in ("ours", "ref"):
        for c in range(2):
            d = tmp_path / side / "imgs" / f"id_{c}"
            d.mkdir(parents=True)
            for i in range(3):
                img = np.random.default_rng(10 * c + i).integers(
                    0, 256, (40, 30 + 4 * i, 3)).astype(np.uint8)
                cv2.imwrite(str(d / f"{i}.jpg"), img)
            (d / "broken.png").write_bytes(b"not an image")
    stats = fd_processing.process_tree(str(tmp_path / "ours" / "imgs"),
                                       out_size=16, detector=detector)
    ref = jax_fd.process_tree(str(tmp_path / "ref" / "imgs"), out_size=16,
                              detector=detector)
    assert stats == ref
    assert stats["total"] == 8 and stats["failed"] == 2
    ours = _tree_bytes(tmp_path / "ours" / "imgs_fd")
    assert len(ours) == 6 and ours == _tree_bytes(tmp_path / "ref" / "imgs_fd")


@pytest.fixture(scope="module")
def embed_src(tmp_path_factory):
    """fr_tpu's test_embed_tool_roundtrip setup: ResNet18 at 32 px, an .npz
    of flax-initialised weights, 5 PNGs in 2 class dirs (0 and 4
    identical); written once, copied into each test's directory."""
    root = tmp_path_factory.mktemp("embed_src")
    conf = jax_configs.load_config("lfw", network="ResNet18")
    conf.img_size = 32
    encoder = jax_build_encoder(conf)
    variables = jax.jit(encoder.init, static_argnames="train")(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
        train=False)
    export_encoder(str(root / "enc.npz"), variables["params"],
                   variables.get("batch_stats", {}), 1, "ResNet18")
    imgs = np.random.default_rng(0).integers(
        0, 256, (4, 32, 32, 3)).astype(np.uint8)
    for i in range(5):
        d = root / "faces" / f"id_{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"im{i}.png"), imgs[i % 4][..., ::-1])
    return root


@pytest.fixture
def embed_ckpt(tmp_path, embed_src):
    shutil.copytree(embed_src, tmp_path, dirs_exist_ok=True)
    return tmp_path / "enc.npz"


def _run_embed(main, tmp_path, ckpt, out, extra=()):
    rc = main(["--ckpt", str(ckpt), "--network", "ResNet18", "--config",
               "lfw", "--input_dir", str(tmp_path / "faces"), "--out",
               str(tmp_path / out), "--batch", "3", "--img_size", "32",
               *extra])
    assert rc == 0
    files = (tmp_path / f"{out}.files.txt").read_text().splitlines()
    return np.load(tmp_path / f"{out}.npy"), files


def _f32(load_config):
    def load(*args, **kwargs):
        conf = load_config(*args, **kwargs)
        conf.mixed_precision = False
        return conf
    return load


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_embed_tool_equals_fr_tpu(tmp_path, monkeypatch, precision,
                                  embed_ckpt):
    ckpt = embed_ckpt
    if precision == "f32":  # both tools read their config in main()
        for mod in (jax_configs, configs):
            monkeypatch.setattr(mod, "load_config", _f32(mod.load_config))
    ref, ref_files = _run_embed(jax_embed.main, tmp_path, ckpt, "ref")
    ours, files = _run_embed(embed.main, tmp_path, ckpt, "ours",
                             ["--device", "cpu"])
    assert files == ref_files and len(files) == 5
    assert ours.shape == ref.shape == (5, 512) and ours.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-5)
    if precision == "f32":
        assert np.abs(ours - ref).max() <= 1e-4
    else:
        assert (np.sum(ours * ref, axis=1) >= 0.99).all()
    by_name = {"/".join(f.split("/")[-2:]): i for i, f in enumerate(files)}
    np.testing.assert_array_equal(ours[by_name["id_0/im0.png"]],
                                  ours[by_name["id_0/im4.png"]])


def test_embed_tool_pth_gives_the_npz_bits(tmp_path, capsys, embed_ckpt):
    ckpt = embed_ckpt
    conf = configs.load_config("lfw", network="ResNet18")
    conf.img_size = 32
    encoder = build_encoder(conf)
    encoder.load_state_dict(load_encoder_npz(str(ckpt), "ResNet18", 32),
                            strict=True)
    export_encoder_pth(str(tmp_path / "enc.pth"), encoder, "ResNet18", 1)
    npz, files = _run_embed(embed.main, tmp_path, ckpt, "npz",
                            ["--device", "cpu"])
    pth, files_pth = _run_embed(embed.main, tmp_path, tmp_path / "enc.pth",
                                "pth", ["--device", "cpu"])
    assert files == files_pth
    np.testing.assert_array_equal(npz, pth)
    assert "embedded 5 images (ResNet18, 512-d, cpu)" in \
        capsys.readouterr().out


def test_embed_tool_raises_without_cuda(tmp_path, embed_ckpt):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _run_embed(embed.main, tmp_path, embed_ckpt, "x")


def _summary_lines(text: str) -> dict:
    keys = ("encoder total", "BN running stats", "PartialFC head (sharded)")
    return {k: line for line in text.splitlines() for k in keys
            if line.startswith(k)}


@pytest.mark.parametrize("network", ["ResNet18", "Swin18"])
def test_model_summary_totals_equal_fr_tpu(network):
    conf = configs.load_config("lfw", network=network)
    jconf = jax_configs.load_config("lfw", network=network)
    head = pfc_config_from_conf(conf).num_classes_padded * conf.emd_size
    jhead = jax_pfc_config(jconf, 1).num_classes_padded * jconf.emd_size
    encoder = jax_build_encoder(jconf)
    x = jnp.zeros((1, jconf.img_size, jconf.img_size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: encoder.init(k, x, train=False),
                            jax.random.key(0))
    ref = _summary_lines(jax_model_summary(
        shapes["params"], shapes.get("batch_stats", {}), head_params=jhead))
    ours = _summary_lines(model_summary(build_encoder(conf),
                                        head_params=head))
    assert len(ours) == 3 and ours == ref


def test_task_logs_the_summary(capsys):
    conf = configs.load_config("ms1m_arcface_122", network="ResNet18")
    conf.update(img_size=32, n_classes=16)
    task = FaceRecognitionTask(conf, stage="test", device="cpu")
    out = capsys.readouterr().out
    assert model_summary(task.encoder, head_params=16 * 512) in out


@pytest.mark.parametrize("network", ["ResNet100", "AlterNet50", "Swin50",
                                     "EffiAlter_m"])
def test_encoder_forward_flops_equal_fr_tpu(network):
    """Full width, one image: fr_tpu's count_flops over the jaxpr of the
    eval-mode forward with the plain attention (fused_attn False, as
    bench.py counts), traced on abstract weights."""
    conf = configs.load_config("ms1m_arcface_122", network=network)
    jconf = jax_configs.load_config("ms1m_arcface_122", network=network)
    jconf = type(jconf)(**{**dict(jconf), "fused_attn": False})
    encoder = jax_build_encoder(jconf)
    x = jnp.zeros((1, jconf.img_size, jconf.img_size, 3), jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: encoder.init(k, x, train=False),
                            jax.random.key(0))
    ref = count_flops(
        lambda p, b, im: encoder.apply({"params": p, "batch_stats": b}, im,
                                       train=False),
        shapes["params"], shapes.get("batch_stats", {}), x)
    ours = encoder_forward_flops(conf)
    assert ours == pytest.approx(ref, rel=0.01)
    assert ours > 1e9
