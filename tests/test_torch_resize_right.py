"""dmtpu_torch.ops.resize_right against dmtpu.ops.resize_right, on the CPU.

The port resizes NCHW tensors, the JAX package NHWC arrays; the same
numpy-seeded images go through both.  Both build their matrices with the same
float64 numpy code (the matrices must be equal) and apply them in f32, in
another summation order: tolerance 1e-5 absolute on values of order 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.ops import resize_right as jrr
from dmtpu_torch.ops import resize_right as trr
from tests._torch_helpers import nhwc, t

TOL = dict(rtol=0, atol=1e-5)
METHODS = ["cubic", "lanczos2", "lanczos3", "linear", "box"]


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randn(2, 3, h, w).astype(np.float32)


@pytest.mark.parametrize("scale", [0.125, 0.3, 0.5, 2, 8])
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method, scale):
    """Every method at every scale, on a non-square image."""
    x = _image(16, 24, seed=int(scale * 8))
    got = trr.resize(t(x), scale_factors=scale, interp_method=method)
    want = np.asarray(jrr.resize(jnp.asarray(nhwc(x)), scale_factors=scale, interp_method=method))
    assert got.dtype == torch.float32 and got.shape[-2:] == want.shape[1:3]
    np.testing.assert_allclose(nhwc(got.numpy()), want, **TOL)


@pytest.mark.parametrize("kw", [dict(out_shape=(5, 40)), dict(scale_factors=(0.5, 2.0)),
                                dict(scale_factors=0.25, antialiasing=False),
                                dict(out_shape=(16, 9), interp_method="lanczos3")])
def test_resize_by_shape_per_dim_scales_and_without_antialiasing(kw):
    x = _image(16, 20, seed=3)
    got = trr.resize(t(x), **kw)
    want = np.asarray(jrr.resize(jnp.asarray(nhwc(x)), **kw))
    np.testing.assert_allclose(nhwc(got.numpy()), want, **TOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("in_sz,out_sz", [(256, 32), (32, 256), (24, 7)])
def test_the_matrices_are_the_jax_package_s(method, in_sz, out_sz):
    scale = out_sz / in_sz
    np.testing.assert_array_equal(trr.make_resize_matrix(in_sz, out_sz, scale, method),
                                  jrr.make_resize_matrix(in_sz, out_sz, scale, method))


def test_a_matrix_is_built_once_per_size_and_device_and_other_layouts_take_spatial_dims():
    a = trr.resize_matrix(64, 8, 0.125, "cubic", True, torch.device("cpu"))
    assert trr.resize_matrix(64, 8, 0.125, "cubic", True, torch.device("cpu")) is a
    assert a.dtype == torch.float32 and a.shape == (8, 64)
    # NHWC through spatial_dims gives the NCHW result, moved
    x = _image(16, 16, seed=4)
    nchw = trr.resize(t(x), scale_factors=0.5)
    nhwc_ = trr.resize(t(nhwc(x)), scale_factors=0.5, spatial_dims=(-3, -2))
    np.testing.assert_allclose(nhwc_.numpy(), nhwc(nchw.numpy()), rtol=0, atol=1e-6)
