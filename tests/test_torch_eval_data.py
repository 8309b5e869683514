"""The port's evaluation data layer against fr_tpu on the same files: the
bcolz rootdir reader, PairDataset over bcolz / .npy / .npz, CrossDataset
over a csv of JPEGs, the all-pairs cross_score, the device scoring
functions (on the CPU here) against the host's f64 result, and
export_encoder_pth against fr_tpu's. Every file is written by the test."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.configs import load_config
from fr_tpu.data import bcolz_reader as jax_bcolz
from fr_tpu.data.pairs import CrossDataset as JaxCrossDataset
from fr_tpu.data.pairs import PairDataset as JaxPairDataset
from fr_tpu.eval import verification as jax_verification
from fr_tpu.models import build_encoder as jax_build_encoder
from fr_tpu.parallel import make_mesh
from fr_tpu.train.step import make_embed_step as jax_make_embed_step
from fr_tpu.utils.torch_export import export_encoder_pth as jax_export_pth
from fr_tpu.utils.torch_import import load_reference_checkpoint
from fr_tpu_torch.data import bcolz_reader
from fr_tpu_torch.data.pairs import CrossDataset, PairDataset
from fr_tpu_torch.eval import verification
from fr_tpu_torch.models import build_encoder
from fr_tpu_torch.train.step import make_embed_step
from fr_tpu_torch.utils.jax_import import encoder_state_dict_from_jax
from fr_tpu_torch.utils.torch_export import export_encoder_pth
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

needs_blosc = pytest.mark.skipif(not bcolz_reader.blosc_available(),
                                 reason="libblosc not present")


def _write_rootdir_genuine(root: Path, arr: np.ndarray, chunklen: int,
                           cname: str = "blosclz") -> None:
    """bcolz 1.2.1's carray_ext.pyx write_meta/flush layout (a copy of
    tests/test_bcolz_reader.py's writer, compressing with the port's
    compress_chunk): repr-quoted base dtype, the full multidim shape, the
    quantize cparam, an __attrs__ file, and chunks of ``chunklen``
    leading-axis items with a smaller leftover chunk."""
    (root / "meta").mkdir(parents=True)
    (root / "data").mkdir()
    base = arr.dtype.base
    (root / "meta" / "sizes").write_text(json.dumps(
        {"shape": [int(s) for s in arr.shape], "nbytes": int(arr.nbytes),
         "cbytes": int(arr.nbytes // 3)}))
    (root / "meta" / "storage").write_text(json.dumps(
        {"dtype": repr(base)[6:-1],
         "cparams": {"clevel": 5, "shuffle": 1, "cname": cname,
                     "quantize": 0},
         "chunklen": chunklen, "dflt": 0.0,
         "expectedlen": int(arr.shape[0])}))
    (root / "__attrs__").write_text("{}")
    flat = np.ascontiguousarray(arr)
    for i, s in enumerate(range(0, arr.shape[0], chunklen)):
        part = flat[s:s + chunklen].tobytes()
        (root / "data" / f"__{i}.blp").write_bytes(
            bcolz_reader.compress_chunk(part, base.itemsize, cname=cname))


def _pair_images(rng, n_pairs, img=8):
    return rng.standard_normal((2 * n_pairs, 3, img, img)).astype(np.float32)


@needs_blosc
@pytest.mark.parametrize("cname", ["blosclz", "lz4", "zlib", "zstd"])
def test_read_carray_equals_fr_tpu(tmp_path, cname):
    """10 items in chunks of 4, 4 and a partial 2."""
    arr = np.random.default_rng(1).standard_normal(
        (10, 3, 8, 8)).astype(np.float32)
    root = tmp_path / "lfw"
    _write_rootdir_genuine(root, arr, chunklen=4, cname=cname)
    ours = bcolz_reader.read_carray(str(root))
    ref = jax_bcolz.read_carray(str(root))
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, arr)
    chunk = (root / "data" / "__2.blp").read_bytes()
    assert bcolz_reader.decompress_chunk(chunk) == \
        jax_bcolz.decompress_chunk(chunk)


@needs_blosc
def test_read_carray_insightface_meta_equals_fr_tpu(tmp_path):
    """The verbatim meta text of insightface's published LFW-family
    rootdirs, at a small shape."""
    rng = np.random.default_rng(8)
    n, c, hw = 12, 3, 8
    arr = (rng.standard_normal((n, c, hw, hw)) * 0.5).astype(np.float32)
    root = tmp_path / "lfw"
    (root / "meta").mkdir(parents=True)
    (root / "data").mkdir()
    (root / "meta" / "sizes").write_text(
        '{"shape": [%d, %d, %d, %d], "nbytes": %d, "cbytes": %d}'
        % (n, c, hw, hw, arr.nbytes, arr.nbytes // 2))
    (root / "meta" / "storage").write_text(
        '{"dtype": "\'float32\'", "cparams": {"shuffle": 1, '
        '"cname": "blosclz", "clevel": 5, "quantize": 0}, '
        '"chunklen": 5, "dflt": 0.0, "expectedlen": %d}' % n)
    (root / "__attrs__").write_text("{}")
    flat = np.ascontiguousarray(arr)
    for i, s in enumerate(range(0, n, 5)):
        (root / "data" / f"__{i}.blp").write_bytes(
            bcolz_reader.compress_chunk(flat[s:s + 5].tobytes(), 4))
    ours = bcolz_reader.read_carray(str(root))
    np.testing.assert_array_equal(ours, jax_bcolz.read_carray(str(root)))
    np.testing.assert_array_equal(ours, arr)


@needs_blosc
def test_read_carray_rejects_a_chunk_gap(tmp_path):
    arr = np.random.default_rng(9).standard_normal((12, 4)).astype(
        np.float32)
    root = tmp_path / "gappy"
    _write_rootdir_genuine(root, arr, chunklen=4)
    (root / "data" / "__1.blp").rename(root / "data" / "__5.blp")
    with pytest.raises(ValueError, match="non-contiguous"):
        bcolz_reader.read_carray(str(root))


def _write_pair_root(tmp_path, layout, n_pairs=7, img=8, seed=4):
    rng = np.random.default_rng(seed)
    arr = _pair_images(rng, n_pairs, img)
    labels = rng.integers(0, 2, n_pairs).astype(bool)
    base = tmp_path / "agedb_30"
    if layout == "bcolz":
        _write_rootdir_genuine(base, arr, chunklen=3)
    elif layout == "npy":
        np.save(str(base) + ".npy", arr)
    else:
        np.savez(str(base) + ".npz", arr)
    np.save(str(base) + "_list.npy", labels)
    return base, arr, labels


@pytest.mark.parametrize("layout", [
    pytest.param("bcolz", marks=needs_blosc), "npy", "npz"])
@pytest.mark.parametrize("seed", [0, None])
def test_pair_dataset_equals_fr_tpu(tmp_path, layout, seed):
    base, arr, labels = _write_pair_root(tmp_path, layout)
    ours = PairDataset(str(base), img_size=8, shuffle_seed=seed)
    ref = JaxPairDataset(str(base), img_size=8, shuffle_seed=seed)
    assert ours.pairs.dtype == ref.pairs.dtype == np.float32
    np.testing.assert_array_equal(ours.pairs, ref.pairs)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert len(ours) == 7
    for (pa, la), (pb, lb) in zip(ours.batches(3), ref.batches(3)):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(la, lb)
    if seed is None:   # pair i, side j is image 2i + j, NHWC
        np.testing.assert_array_equal(ours.pairs[1, 0],
                                      np.transpose(arr[2], (1, 2, 0)))


def test_pair_dataset_missing_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="no pair data"):
        PairDataset(str(tmp_path / "cplfw"), img_size=8)


def write_cross_set(root: Path, n_classes: int, per_class: int,
                    img_size: int, seed: int = 3) -> Path:
    """A cross test set: <root>/imgs/<name>.csv rows (file, label) and the
    JPEGs beside it (the reference's TEST_DATASET layout)."""
    import cv2
    from fr_tpu_torch.data.synthetic import synthetic_corpus
    imgs, labels = synthetic_corpus(n_classes, per_class, img_size, seed)
    img_dir = root / "imgs"
    img_dir.mkdir(parents=True)
    rows = []
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        name = f"{i:05d}.jpg"
        cv2.imwrite(str(img_dir / name), cv2.cvtColor(img,
                                                      cv2.COLOR_RGB2BGR))
        rows.append(f"{name},{lab}\n")
    (img_dir / f"{root.name}.csv").write_text("".join(rows))
    return root


def test_cross_dataset_equals_fr_tpu(tmp_path):
    pytest.importorskip("cv2")
    pytest.importorskip("pandas")
    root = write_cross_set(tmp_path / "cross_set", 5, 3, 12)
    ours = CrossDataset(str(root), img_size=16)
    ref = JaxCrossDataset(str(root), img_size=16)
    assert len(ours) == len(ref) == 15
    np.testing.assert_array_equal(ours.files, ref.files)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    got = list(ours.batches(4))
    want = list(ref.batches(4))
    assert len(got) == len(want) == 4
    for (xa, la), (xb, lb) in zip(got, want):
        assert xa.dtype == np.float32 and xa.shape[1:] == (16, 16, 3)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)


def _unit(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,classes,dtype", [
    (100, 64, 10, np.int64), (257, 512, 64, np.int32)])
def test_cross_score_equals_fr_tpu(n, d, classes, dtype):
    """Bin-exact histograms, the same scores and pair labels, in the
    reference's order (i outer, j inner)."""
    rng = np.random.default_rng(d)
    emb = _unit(rng, n, d)
    labels = rng.integers(0, classes, n).astype(dtype)
    ours = verification.cross_score(emb, labels)
    ref = jax_verification.cross_score(emb, labels)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert len(ours[2]) == n * (n - 1) // 2
    assert ours[3][0] == float(labels[1] == labels[0])


def _near_edge(scores, margin):
    """How many scores lie within ``margin`` of a bin edge k / (1e5 − 1)."""
    x = (1e5 - 1.0) * np.asarray(scores, np.float64)
    return int(np.sum(np.abs(x - np.round(x)) <= margin * (1e5 - 1.0)))


def check_cross_device(dev, host, margins=(1e-5, 1e-7)):
    """The cross_score_device comparison: equal genuine and imposter
    totals; the cumulative histograms differ nowhere by more than the
    number of host scores within each margin of a bin edge. A bin is
    1.00001e-5 wide, so every score lies within 1e-5 of an edge; 1e-7, the
    f32 rounding of d² at unit norms, is the margin that can fail. Returns
    the largest cumulative difference."""
    hg, hi = dev
    rhg, rhi, scores, _ = host
    assert hg.sum() == rhg.sum() and hi.sum() == rhi.sum()
    worst = max(int(np.abs(np.cumsum(a) - np.cumsum(b)).max())
                for a, b in ((hg, rhg), (hi, rhi)))
    for margin in margins:
        near = _near_edge(scores, margin)
        assert worst <= near, (worst, margin, near)
    return worst


@pytest.mark.parametrize("n,d", [(400, 64), (1000, 512)])
def test_pair_score_device_against_the_host(n, d):
    rng = np.random.default_rng(n)
    e1, e2 = _unit(rng, n, d), _unit(rng, n, d)
    e2[: n // 2] = e1[: n // 2] + 0.1 * e2[: n // 2]   # genuine-like pairs
    labels = rng.integers(0, 2, n)
    hg, hi, scores = verification.pair_score_device(e1, e2, labels,
                                                    device="cpu")
    rhg, rhi, rscores = verification.pair_score(e1, e2, labels)
    assert hg.dtype == hi.dtype == scores.dtype == np.float64
    assert hg.sum() == rhg.sum() and hi.sum() == rhi.sum()
    np.testing.assert_allclose(scores, rscores, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,d,block", [(300, 64, 128), (1024, 512, 512)])
def test_cross_score_device_against_the_host(n, d, block):
    rng = np.random.default_rng(n)
    emb = _unit(rng, n, d)
    labels = rng.integers(0, n // 4, n)
    dev = verification.cross_score_device(emb, labels, device="cpu",
                                          block=block)
    assert dev[0].dtype == dev[1].dtype == np.float64
    check_cross_device(dev, verification.cross_score(emb, labels))


def _seeded_stats(tree, rng):
    """BN statistics away from their init, so that a mix-up shows."""
    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return rng.normal(0.0, 0.1, x.shape).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("network,img_size", [("ResNet18", 32),
                                              ("AlterNet50", 96)])
def test_export_encoder_pth_equals_fr_tpu(tmp_path, network, img_size):
    """The same seeded flax weights, carried into the port with jax_import:
    the port's .pth holds fr_tpu's state dict tensor for tensor, and
    fr_tpu's load_reference_checkpoint reads it back into embeddings within
    1e-5 of the port's (f32)."""
    conf = load_config("ms1m_arcface_122", network=network)
    conf.update(img_size=img_size, mixed_precision=False)
    x = np.random.default_rng(7).standard_normal(
        (2, img_size, img_size, 3)).astype(np.float32)
    enc = jax_build_encoder(conf)
    variables = jax.jit(lambda k, v: enc.init(k, v, train=False))(
        jax.random.key(3), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _seeded_stats(variables["batch_stats"],
                          np.random.default_rng(11))
    model = build_encoder(conf)
    model.load_state_dict(encoder_state_dict_from_jax(
        params, stats, network, img_size), strict=True)

    ours, ref = tmp_path / "ours.pth", tmp_path / "ref.pth"
    export_encoder_pth(str(ours), model, network, epoch=5)
    jax_export_pth(str(ref), params, stats, network, epoch=5,
                   img_size=img_size)
    a = torch.load(ours, weights_only=True)
    b = torch.load(ref, weights_only=True)
    assert (a["epoch"], a["name"]) == (b["epoch"], b["name"]) == (5, network)
    sa, sb = a["model_state_dict"], b["model_state_dict"]
    assert sorted(sa) == sorted(sb)
    for k in sb:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k

    r_params, r_stats = load_reference_checkpoint(str(ours), network)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    back = np.asarray(jax_make_embed_step(conf, mesh, enc)(
        r_params, r_stats, jnp.asarray(x)))
    out = make_embed_step(conf, model, "cpu")(x).numpy()
    assert np.abs(back - out).max() <= 1e-5


@pytest.mark.parametrize("network", ["AlterNetV1_50", "AlterNetSep50"])
def test_export_encoder_pth_raises_without_a_naming(tmp_path, network):
    with pytest.raises(NotImplementedError, match=network):
        export_encoder_pth(str(tmp_path / "x.pth"), {}, network)
