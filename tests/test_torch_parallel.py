"""The port's parallelism in one process (the two-rank runs are in
test_torch_parallel_dist.py):

- the Megatron plan (``parallel/tp.py::unet_tp_plan``) against ``sd_tpu``'s
  ``unet_tp_specs`` on sd_tpu's TP test UNet (with and without
  ``use_scale_shift_norm``): for every parameter the same sharded dim,
  mapped from flax's layout to torch's through ``utils/convert.py``, or
  replicated, at n = 2, 4 and 8 with and without ``num_heads``;
- the loader's shards (``DataLoader(num_shards, shard_index)``) and
  ``Txt2ImgIterableBaseDataset.shard`` against ``sd_tpu``'s for the same
  seed, epoch and shard: the same indices in the same batches, and the
  same length;
- the LR rule at N devices against ``sd_tpu``'s, the draws of a rank
  (``RowDraws``: its block, or its rows r::n, of one process's draws), and
  the refusals: an indivisible batch, a shard out of range, an unknown
  backend, NCCL on the CPU or with more ranks than cards on a host (the
  message names ``--backend gloo``), no ``torchrun`` environment, and
  tensor parallelism in the fused (K7) or Winograd (K8) conv mode;
- every rank of a stream that the ranks do not divide stops at
  ``len(loader)`` batches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.data.base import DataLoader as JaxDataLoader
from sd_tpu.data.base import Dataset as JaxDataset
from sd_tpu.data.base import Txt2ImgIterableBaseDataset as JaxStream
from sd_tpu.models.unet import UNetConfig as JaxUNetConfig
from sd_tpu.models.unet import UNetModel as JaxUNet
from sd_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sd_tpu.parallel.tp import unet_tp_specs
from sd_tpu.training.trainer import scale_learning_rate as jax_scale_learning_rate
from sd_tpu_torch.core.draws import RowDraws, draw
from sd_tpu_torch.data.base import DataLoader, Dataset, Txt2ImgIterableBaseDataset
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.ops.resblock import set_conv_modes
from sd_tpu_torch.parallel import mesh as pmesh
from sd_tpu_torch.parallel.sharded_sampling import sharded_sample
from sd_tpu_torch.parallel.tp import RowParallelConv3x3, parallelize_unet, unet_tp_plan
from sd_tpu_torch.training.trainer import scale_learning_rate
from sd_tpu_torch.utils.convert import unet_state_dict

# sd_tpu's TP test UNet (tests/test_tp_spmd.py::tp_unet)
TP_UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=[1, 2], channel_mult=[1, 2], num_heads=4,
               use_spatial_transformer=True, transformer_depth=1, context_dim=32,
               image_size=16)


@pytest.fixture(scope="module", params=[False, True], ids=["add", "scale_shift"])
def unet_shapes(request):
    """(sd_tpu's parameter tree of zeros, the port's config and its
    parameter shapes) of the TP UNet, with or without scale-shift norm."""
    p = dict(TP_UNET, use_scale_shift_norm=request.param)
    jcfg = JaxUNetConfig(**p)
    shapes = jax.eval_shape(lambda: JaxUNet(config=jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 4)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 7, 32))))["params"]
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    cfg = UNetConfig(**p)
    with torch.device("meta"):
        port = UNetModel(cfg)
    return params, cfg, {n: tuple(t.shape) for n, t in port.named_parameters()}


def _flax_dims_in_torch(params, specs, cfg):
    """Each flax leaf marked along its sharded dim (0 where replicated),
    converted to the port's names and layout: the dim along which a torch
    tensor varies is the one sd_tpu shards, or None."""
    def marker(leaf, sharding):
        dims = [i for i, ax in enumerate(sharding.spec) if ax is not None]
        if not dims:
            return np.zeros(leaf.shape, np.float32)
        (d,) = dims
        shape = [1] * leaf.ndim
        shape[d] = leaf.shape[d]
        return np.broadcast_to(np.arange(1, leaf.shape[d] + 1, dtype=np.float32)
                               .reshape(shape), leaf.shape).copy()

    marked = jax.tree.map(marker, params, specs)
    out = {}
    for name, arr in unet_state_dict(marked, cfg).items():
        varying = [k for k in range(arr.ndim) if arr.shape[k] > 1 and np.ptp(arr, axis=k).any()]
        assert len(varying) <= 1, (name, varying)
        out[name] = varying[0] if varying else None
    return out


@pytest.mark.parametrize("num_heads", [None, 4])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_plan_matches_sd_tpu(unet_shapes, n, num_heads, monkeypatch):
    params, cfg, shapes = unet_shapes
    # unet_tp_specs sets SD_TPU_FUSED_FF=0 where it is unset; keep it to this test
    monkeypatch.setenv("SD_TPU_FUSED_FF", "0")
    specs = unet_tp_specs(jax_make_mesh(n_data=8 // n, n_model=n), params, num_heads=num_heads)
    want = _flax_dims_in_torch(params, specs, cfg)
    got = unet_tp_plan(shapes, n, num_heads)
    assert got.keys() == want.keys()
    assert got == want
    sharded = {k for k, d in got.items() if d is not None}
    assert any("in_layers.2" in k for k in sharded)  # the ResBlock pair is sharded
    assert any("attn1.to_q" in k for k in sharded) == (num_heads is not None and 4 % n == 0)
    assert "out.2.weight" not in sharded  # the UNet's output conv stays replicated


class _Indices(Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


class _JaxIndices(JaxDataset):
    __init__, __len__, __getitem__ = _Indices.__init__, _Indices.__len__, _Indices.__getitem__


@pytest.mark.parametrize("n,shards,shard,shuffle,epoch", [
    (10, 1, 0, False, 0), (10, 2, 0, True, 0), (10, 2, 1, True, 3), (11, 3, 2, True, 1),
    (64, 4, 3, True, 2)])
def test_loader_shards_match_sd_tpu(n, shards, shard, shuffle, epoch):
    port = DataLoader(_Indices(n), batch_size=2, shuffle=shuffle, seed=5, num_shards=shards,
                      shard_index=shard)
    ref = JaxDataLoader(_JaxIndices(n), batch_size=2, shuffle=shuffle, seed=5,
                        num_shards=shards, shard_index=shard, prefetch=0)
    port.epoch = ref.epoch = epoch
    np.testing.assert_array_equal(port.order(), ref._index_iter())
    assert len(port) == len(ref)
    got = [b["i"].tolist() for b in port]
    want = [b["i"].tolist() for b in ref][:len(port)]
    assert got == want and len(got) == len(port)


class _Stream(Txt2ImgIterableBaseDataset):
    def __iter__(self):
        for i in self.sample_ids:
            yield {"i": np.int64(i)}


class _JaxStream(JaxStream):
    __iter__ = _Stream.__iter__


@pytest.mark.parametrize("records,workers,worker", [(10, 3, 0), (10, 3, 2), (7, 2, 1),
                                                    (9, 1, 0)])
def test_iterable_shard_matches_sd_tpu(records, workers, worker):
    assert (_Stream(num_records=records).shard(worker, workers).sample_ids
            == _JaxStream(num_records=records).shard(worker, workers).sample_ids)
    port = DataLoader(_Stream(num_records=records), batch_size=2, num_shards=workers,
                      shard_index=worker)
    ref = JaxDataLoader(_JaxStream(num_records=records), batch_size=2, num_shards=workers,
                        shard_index=worker)
    got = [b["i"].tolist() for b in port]
    # sd_tpu's larger blocks may yield one batch more; the port stops at len
    assert got == [b["i"].tolist() for b in ref][:len(port)] and len(got) == len(port)


@pytest.mark.parametrize("records", [7, 9, 11])
def test_iterable_shards_take_equal_steps(records):
    """Two ranks over a stream that 2 does not divide: each yields
    ``len(loader)`` batches (DDP steps in lockstep), of its own block."""
    loaders = [DataLoader(_Stream(num_records=records), batch_size=2, num_shards=2,
                          shard_index=r) for r in range(2)]
    got = [[b["i"].tolist() for b in loader] for loader in loaders]
    assert len(loaders[0]) == len(loaders[1]) == records // 2 // 2
    assert [len(g) for g in got] == [len(loaders[0])] * 2
    blocks = np.array_split(np.arange(records), 2)
    for g, block in zip(got, blocks):
        assert sum(g, []) == block[:len(sum(g, []))].tolist()


@pytest.mark.parametrize("devices,batch", [(1, 4), (2, 2), (8, 4)])
def test_learning_rate_rule(devices, batch):
    got = scale_learning_rate(1e-4, batch, devices)
    assert got == jax_scale_learning_rate(1e-4, batch, devices) == devices * batch * 1e-4


@pytest.mark.parametrize("strided", [False, True])
def test_row_draws_are_a_ranks_rows(strided):
    shape, n = (6, 3, 2), 3
    full = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    rows = [draw(torch.randn, (2, 3, 2), RowDraws(torch.Generator().manual_seed(1), r, n,
                                                  strided), "cpu") for r in range(n)]
    want = [full[r::n] for r in range(n)] if strided else list(full.split(2))
    for got, w in zip(rows, want):
        assert torch.equal(got, w)
    # without a RowDraws, draw is the generator's own call, bit for bit
    assert torch.equal(draw(torch.randn, shape, torch.Generator().manual_seed(1), "cpu"), full)


class _Mesh:
    """A DeviceMesh's interface for rank 1 of a 2-rank ``data`` dim; the
    refusals come before any collective."""

    mesh_dim_names = ("data", "model")

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 1

    def size(self, dim):
        return 2 if dim == 0 else 1


class _ModelMesh(_Mesh):
    """Rank 1 of a 2-rank ``model`` dim."""

    def size(self, dim):
        return 2 if dim == 1 else 1


@pytest.mark.parametrize("fused_conv,conv_impl", [("force", "auto"), ("auto", "winograd")],
                         ids=["K7", "K8"])
def test_tp_refuses_the_fused_and_winograd_conv_modes(fused_conv, conv_impl):
    """The kernels of both modes add the bias (K7 the skip too) before a
    row-parallel conv's sum: tensor parallelism refuses them, and a parallel
    block raises where the Winograd mode is set afterwards."""
    unet = UNetModel(UNetConfig(**TP_UNET))
    set_conv_modes(unet, fused_conv, conv_impl)
    before = {n: p.shape for n, p in unet.named_parameters()}
    with pytest.raises(ValueError, match="conv mode"):
        parallelize_unet(unet, _ModelMesh(), num_heads=4)
    assert {n: p.shape for n, p in unet.named_parameters()} == before  # nothing was cut
    set_conv_modes(unet, "auto", "auto")
    parallelize_unet(unet, _ModelMesh(), num_heads=4)
    conv = next(m for m in unet.modules() if isinstance(m, RowParallelConv3x3))
    set_conv_modes(unet, "auto", "winograd")
    with pytest.raises(ValueError, match="Winograd"):
        conv(torch.zeros(1, conv.in_channels, 4, 4))


def test_indivisible_batches_are_refused():
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(_Mesh(), {"x": np.zeros((3, 2))})
    with pytest.raises(ValueError, match="does not divide"):
        sharded_sample(_Mesh(), None, None, None, (3, 4, 8, 8), None)
    assert pmesh.shard_batch(_Mesh(), {"x": np.arange(4)})["x"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="shard 2 of 2"):
        DataLoader(_Indices(4), batch_size=1, num_shards=2, shard_index=2)


def test_init_distributed_refusals(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        pmesh.init_distributed("gloo", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        pmesh.init_distributed("mpi", "cpu")
    with pytest.raises(ValueError, match="use --backend gloo on the CPU"):
        pmesh.init_distributed("nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="run them with --backend gloo"):
        pmesh.init_distributed("nccl", "cuda")
    assert not torch.distributed.is_initialized()
