"""The port's mesh and collectives (fr_tpu_torch/parallel) against fr_tpu's
mesh (fr_tpu/parallel/mesh.py) on 4 of the conftest's 8 virtual CPU
devices: the factorisation and its defaults and assert, the order of ranks
in the mesh, the class split; then, at 4 gloo ranks of a (2, 2) mesh
(tests/torch_multigpu_worker.py), each collective and its gradient held
against the same function computed in one process, and embed_global_batch
of 10 images (not a multiple of 4) against the one-device embeddings."""

import jax
import numpy as np
import pytest
import torch

from fr_tpu.parallel import mesh as jax_mesh
from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.models.common import init_weights
from fr_tpu_torch.parallel.mesh import (Mesh, local_class_slice, make_mesh,
                                        mesh_coords, mesh_shape, pad_classes)
from fr_tpu_torch.train.step import embed_global_batch, make_embed_step
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_multigpu_worker import run_job, seeded, small_resnet

SHAPES = [(None, None), (2, None), (None, 2), (1, 4), (4, 1), (2, 2),
          (None, 4), (4, None)]


@pytest.mark.parametrize("data,model", SHAPES)
def test_mesh_shape_matches_fr_tpu(data, model):
    ref = jax_mesh.make_mesh(data, model, devices=jax.devices()[:4])
    assert mesh_shape(4, data, model) == (ref.shape["data"],
                                          ref.shape["model"])


@pytest.mark.parametrize("data,model", [(3, None), (None, 3), (2, 4)])
def test_mesh_shape_asserts_as_fr_tpu_does(data, model):
    with pytest.raises(AssertionError, match="devices"):
        jax_mesh.make_mesh(data, model, devices=jax.devices()[:4])
    with pytest.raises(AssertionError, match="devices"):
        mesh_shape(4, data, model)


@pytest.mark.parametrize("data,model", [(1, 4), (2, 2), (4, 1)])
def test_rank_order_matches_fr_tpu_device_array(data, model):
    devices = jax.devices()[:4]
    ref = jax_mesh.make_mesh(data, model, devices=devices).devices
    for rank, dev in enumerate(devices):
        (pos,) = np.argwhere(ref == dev)
        assert mesh_coords(rank, model) == tuple(pos)
        assert Mesh(data, model, *pos).rank == rank


def test_class_split_matches_fr_tpu():
    for n in (1, 37, 298, 2059906):
        for m in (1, 2, 3, 4, 8):
            assert pad_classes(n, m) == jax_mesh.pad_classes(n, m)
            padded = pad_classes(n, m)
            for i in range(m):
                assert local_class_slice(padded, m, i) == \
                    jax_mesh.local_class_slice(padded, m, i)


def test_one_process_mesh_has_no_group():
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert mesh.model_group is mesh.data_group is mesh.world_group is None
    with pytest.raises(AssertionError, match="devices"):
        make_mesh(model=2)


NET = {"layers": [1, 1, 1, 1], "emb": 16, "img": 32}
ROWS, DIM, N_IMAGES = 3, 5, 10


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """The four ranks' results of the collectives job and its inputs."""
    encoder = init_weights(small_resnet(NET), 3)
    images = seeded(7, N_IMAGES, NET["img"], NET["img"], 3)
    outs = run_job(tmp_path_factory.mktemp("collectives"), "collectives",
                   (2, 2), rows=ROWS, dim=DIM, net=NET, images=images,
                   encoder=encoder.state_dict())
    return outs, encoder, images


def test_all_gather_and_its_backward(collectives):
    """Forward: the row's blocks in rank order. Backward: the reduce-scatter
    sum of every row member's cotangent of this rank's block."""
    outs, _, _ = collectives
    for r, out in enumerate(outs):
        d, m = mesh_coords(r, 2)
        row = [d * 2 + j for j in range(2)]
        want = torch.cat([seeded(100 + q, ROWS, DIM) for q in row])
        assert torch.equal(out["gathered"], want)
        grad = sum(seeded(200 + q, 2 * ROWS, DIM)[m * ROWS:(m + 1) * ROWS]
                   for q in row)
        torch.testing.assert_close(out["gather_grad"], grad, rtol=1e-6,
                                   atol=1e-6)


def test_psum_pmax_pmean_and_their_gradients(collectives):
    """psum sums over the model group and passes the replicated cotangent
    through unchanged; pmax carries no gradient; pmean averages over the
    data group and over the world."""
    outs, _, _ = collectives
    v = [seeded(300 + q, ROWS) for q in range(4)]
    for r, out in enumerate(outs):
        d, m = mesh_coords(r, 2)
        row = [v[d * 2 + j] for j in range(2)]
        col = [v[i * 2 + m] for i in range(2)]
        torch.testing.assert_close(out["psum"], row[0] + row[1], rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(out["psum_grad"], seeded(400 + d, ROWS))
        assert torch.equal(out["pmax"], torch.maximum(*row))
        assert out["pmax_requires_grad"] is False
        torch.testing.assert_close(out["pmean_data"], (col[0] + col[1]) / 2,
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out["pmean_world"], sum(v) / 4,
                                   rtol=1e-6, atol=1e-6)


def test_embed_global_batch_matches_one_device(collectives):
    """10 images over 4 ranks (padded to 12): every rank gets the 10
    embeddings of the one-device embed step, bit for bit (the encoder in
    eval mode embeds each image alone)."""
    outs, encoder, images = collectives
    embed = make_embed_step(Config(img_size=NET["img"]), encoder, "cpu")
    want = embed_global_batch(embed, images.numpy())
    assert want.shape == (N_IMAGES, NET["emb"])
    for out in outs:
        np.testing.assert_array_equal(out["embeddings"].numpy(), want)
