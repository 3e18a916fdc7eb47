"""The port's native batch assembler (``cbim_tpu_torch/data/native.py``,
``csrc/cbim_host.cpp``) against a numpy window copy, the cases of
``tests/test_native.py``; ``TrainPipeline``'s 3D host batches with the
assembler and without it, also for one rank's rows of a two-rank mesh; a
failed build raising, where the JAX package falls back to numpy."""

import numpy as np
import pytest
import torch

from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data import native
from cbim_tpu_torch.data.datasets import Synthetic3D
from cbim_tpu_torch.data.pipeline import TrainPipeline
from cbim_tpu_torch.parallel.mesh import Mesh
from test_torch_threads import few_torch_threads  # noqa: F401

#: ``tests/test_native.py``'s windows: [z0, y0, x0, wz, wy, wx, oz, oy, ox]
#: of 4 samples of (20, 30, 28) into a (16, 24, 24) buffer
WINDOWS = np.array([[2, 3, 4, 12, 20, 20, 2, 2, 2],
                    [0, 0, 0, 16, 24, 24, 0, 0, 0],
                    [4, 6, 4, 10, 18, 18, 3, 3, 3],
                    [1, 1, 1, 16, 24, 24, 0, 0, 0]], np.int64)
BUFFER = (16, 24, 24)
#: ``tests/test_native.py``'s pipeline config: a synthetic 3D corpus that
#: takes the host windows (``device_cache: false``)
PIPE = dict(
    dataset="synthetic", model="unet", dimension="3d", classes=3,
    in_chan=1, base_chan=4, block="SingleConv", norm="in",
    training_size=[8, 16, 16], affine_pad_size=[2, 4, 4],
    scale=[0.1, 0.2, 0.2], rotate=[10, 0, 0], translate=[0, 0, 0],
    gaussian_noise_std=0.02, additive_brightness_std=0.5,
    gamma_range=[0.7, 1.4], synthetic_cases=4, k_fold=4,
    synthetic_shape=[12, 24, 24], device_cache=False)


def _volumes(seed=0, shape=(20, 30, 28), n=4):
    rng = np.random.RandomState(seed)
    imgs = [np.ascontiguousarray(rng.rand(*shape).astype(np.float32))
            for _ in range(n)]
    labs = [np.ascontiguousarray(rng.randint(0, 5, shape).astype(np.int8))
            for _ in range(n)]
    return imgs, labs


def _numpy_windows(imgs, labs, windows, buffer):
    ref_i = np.zeros((len(imgs), *buffer), np.float32)
    ref_l = np.zeros((len(imgs), *buffer), np.int8)
    for i, (z0, y0, x0, wz, wy, wx, oz, oy, ox) in enumerate(windows):
        ref_i[i, oz:oz + wz, oy:oy + wy, ox:ox + wx] = \
            imgs[i][z0:z0 + wz, y0:y0 + wy, x0:x0 + wx]
        ref_l[i, oz:oz + wz, oy:oy + wy, ox:ox + wx] = \
            labs[i][z0:z0 + wz, y0:y0 + wy, x0:x0 + wx]
    return ref_i, ref_l


def test_native_assemble_matches_numpy():
    imgs, labs = _volumes()
    # garbage first: the assembler writes every byte, padding included
    di = np.full((4, *BUFFER), np.nan, np.float32)
    dl = np.full((4, *BUFFER), 7, np.int8)
    native.assemble_batch(imgs, labs, WINDOWS, di, dl)
    ref_i, ref_l = _numpy_windows(imgs, labs, WINDOWS, BUFFER)
    np.testing.assert_array_equal(di, ref_i)
    np.testing.assert_array_equal(dl, ref_l)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_native_slabs_cover_the_buffer_at_any_pool_size(monkeypatch,
                                                        threads):
    """A pool of 1, 3 or 8 threads splits each sample into as many slabs of
    planes (up to the buffer's depth): the same bytes."""
    monkeypatch.setattr(native, "_pool", (None, None))
    monkeypatch.setattr(torch, "get_num_threads", lambda: threads)
    imgs, labs = _volumes(seed=threads)
    di = np.empty((2, *BUFFER), np.float32)
    dl = np.empty((2, *BUFFER), np.int8)
    native.assemble_batch(imgs[:2], labs[:2], WINDOWS[2:], di, dl)
    ref_i, ref_l = _numpy_windows(imgs[:2], labs[:2], WINDOWS[2:], BUFFER)
    np.testing.assert_array_equal(di, ref_i)
    np.testing.assert_array_equal(dl, ref_l)


def test_native_refuses_what_it_cannot_copy():
    imgs, labs = _volumes(n=1)
    out_i = np.empty((1, *BUFFER), np.float32)
    out_l = np.empty((1, *BUFFER), np.int8)
    with pytest.raises(ValueError):         # int32 labels
        native.assemble_batch(imgs, [labs[0].astype(np.int32)], WINDOWS[:1],
                              out_i, out_l)
    with pytest.raises(ValueError):         # a strided image
        native.assemble_batch([imgs[0][:, ::2]], labs, WINDOWS[:1], out_i,
                              out_l)
    with pytest.raises(ValueError):         # one window for two samples
        native.assemble_batch(imgs * 2, labs * 2, WINDOWS[:1], out_i, out_l)


def _pipe(native_on: bool, mesh=None):
    cfg = config_from_dict(PIPE)
    pipe = TrainPipeline(Synthetic3D(cfg, k_fold=4), cfg, seed=7,
                         device="cpu", mesh=mesh)
    assert pipe.cache_img is None and pipe.native
    pipe.native = native_on
    return pipe


def test_pipeline_native_path_matches_numpy_path():
    """Same seed: the same host batches with the assembler and without it,
    batch after batch."""
    on, off = _pipe(True), _pipe(False)
    for _ in range(3):
        (i1, l1), (i2, l2) = on.host_batch(3), off.host_batch(3)
        assert i1.dtype == i2.dtype == np.float32
        assert l1.dtype == l2.dtype == np.int8
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(l1, l2)


def test_pipeline_native_path_writes_one_ranks_rows():
    """Rank 1 of a two-rank mesh: its rows of the global batch, the same
    with the assembler and without it, and the one-process batch's rows."""
    mesh = Mesh(group=None, node_group=None, rank=1, size=2, local_rank=1,
                local_size=2, node=0, nodes=1, device=torch.device("cpu"))
    whole = _pipe(True).host_batch(4)
    on, off = _pipe(True, mesh).host_batch(4), _pipe(False, mesh).host_batch(4)
    for a, b, w in zip(on, off, whole):
        assert a.shape[0] == 2
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w[2:4])


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source the compiler refuses raises with its output (no numpy
    fallback), and leaves no library behind."""
    bad = tmp_path / "cbim_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="cbim_host.cpp failed"):
        native.assemble_batch(*_volumes(n=1), WINDOWS[:1],
                              np.empty((1, *BUFFER), np.float32),
                              np.empty((1, *BUFFER), np.int8))
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
