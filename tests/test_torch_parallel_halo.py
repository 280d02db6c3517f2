"""The sharded halo conv (``parallel/halo.py``) on 4 gloo ranks on the CPU,
against JAX's unsharded SAME conv and the port's own unsharded conv.

One spawn of 4 ranks serves the whole file (meshes (2, 2), (1, 4) and
(4, 1) over the same world); each rank returns its results gathered whole,
and the tests compare them here.

Bars. The overlapped and the serial halo conv are bitwise equal (the
ranks' PyTorch CPU conv sums each output over the same window in the same
order whatever the tile's height). Against the unsharded conv, which runs
in this process with its own thread count, PyTorch's CPU convolution may
block its sums otherwise (the 3-D case differs in the last bits), so both
are held at 2e-5 (``check_halo``'s bar), as is the kernel path
(``conv2d_gemm``'s plain version on the CPU). Where the ranks compute the
very tile the unsharded conv does (p = 1, and the padding case's fallback)
the test asks for bitwise equality. Gradients (x, w, b) against autograd of the
unsharded conv at 1e-5 of each one's scale (w's sums run over 1024 pixels
in another order; its entries reach ~60).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.nn.layers import conv_local
from repro_torch.nn.module import ShardingCtx
from repro_torch.parallel.halo import HaloConv, spatial_conv2d
from repro_torch.parallel.sharded import Sharded, placement
from repro_torch.parallel.strategies import make_rules

TOL = 2e-5


def _inputs():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "x2": normal(2, 32, 16, 3), "w2": normal(3, 3, 3, 8, scale=0.2),
        "b2": normal(8, scale=0.1),
        "x3": normal(2, 16, 8, 8, 4), "w3": normal(3, 3, 3, 4, 6, scale=0.2),
        "b3": normal(6, scale=0.1),
        "xd": normal(4, 32, 16, 3), "r2": normal(2, 32, 16, 8),
        "xe": normal(2, 8, 16, 3),
        **{f"we{k}": normal(k, k, 3, 8, scale=0.2) for k in (2, 3, 4, 5, 7)},
    }


def _t(a):
    return torch.from_numpy(a)


def _split(x, mesh, spec):
    """This rank's block of a whole tensor, batch and H split as ``spec``."""
    return Sharded.of(x, placement(mesh, spec + (None,) * (x.dim() - 2)),
                      mesh)


def _ranks(mesh22, inp):
    """Everything the tests check, run on every rank; results whole."""
    torch.manual_seed(0)
    mesh14 = Mesh(1, 4, backend="gloo", device=torch.device("cpu"))
    mesh41 = Mesh(4, 1, backend="gloo", device=torch.device("cpu"))
    t = {k: _t(v) for k, v in inp.items()}
    out = {}
    for nd in (2, 3):
        x, w, b = t[f"x{nd}"], t[f"w{nd}"], t[f"b{nd}"]
        xs = _split(x, mesh22, ("data", "model"))
        for overlap in (True, False):
            y = spatial_conv2d(xs, w, mesh22, "model", bias=b,
                               overlap=overlap)
            out[f"sp{nd}_{overlap}"] = y.full().numpy()
    # the deployed layer under the ds rules, plain and on the kernel path
    hc = HaloConv(3, 8, (3, 3), use_bias=True, device=torch.device("cpu"),
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        hc.b.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    xd = Sharded.of(t["xd"], placement(mesh22, ("data", "model", None, None)),
                    mesh22)
    for pl in (False, True):
        ctx = ShardingCtx("cpu", use_pallas=pl, mesh=mesh22,
                          rules=make_rules("ds"))
        with torch.no_grad():
            out[f"hc_{pl}"] = hc(xd, ctx).full().numpy()
    out["hc_w"], out["hc_b"] = hc.w.detach().numpy(), hc.b.detach().numpy()
    # edge cases
    xe = _split(t["xe"], mesh14, (None, "model"))      # H_local = 2
    try:
        spatial_conv2d(xe, t["we7"], mesh14, "model")
        out["thin"] = "no error"
    except ValueError as e:
        out["thin"] = str(e)
    out["thin5"] = spatial_conv2d(xe, t["we5"], mesh14, "model").full().numpy()
    for k in (2, 3, 4):
        for pl in (False, True):
            y = spatial_conv2d(xe, t[f"we{k}"], mesh14, "model",
                               use_pallas=pl)
            out[f"edge{k}_{pl}"] = y.full().numpy()
    hv = HaloConv(3, 8, (3, 3), padding="VALID", use_bias=False,
                  device=torch.device("cpu"),
                  generator=torch.Generator().manual_seed(2))
    ctx = ShardingCtx("cpu", mesh=mesh22, rules=make_rules("ds"))
    with torch.no_grad():
        out["valid"] = hv(xd, ctx).full().numpy()
        out["valid_want"] = hv(t["xd"], ShardingCtx("cpu")).numpy()
    x1 = _split(t["xe"], mesh41, (None, "model"))
    out["p1"] = spatial_conv2d(x1, t["we3"], mesh41, "model").full().numpy()
    try:
        spatial_conv2d(xe, t["we3"], mesh14, "model", strides=(2, 2))
        out["stride"] = "no error"
    except ValueError as e:
        out["stride"] = str(e)
    # backward: the transposed exchange against autograd of the whole conv
    x = _split(t["x2"], mesh22, ("data", "model"))
    x.local.requires_grad_()
    w = t["w2"].clone().requires_grad_()
    b = t["b2"].clone().requires_grad_()
    r = _split(t["r2"], mesh22, ("data", "model")).local
    for overlap in (True, False):
        y = spatial_conv2d(x, w, mesh22, "model", bias=b, overlap=overlap)
        gx, gw, gb = torch.autograd.grad((y.local * r).sum(),
                                         (x.local, w, b))
        gx = Sharded(gx, x.shape, x.place, mesh22).full()
        world = mesh22.group(("data", "model"))
        from repro_torch.parallel.collectives import all_reduce_sum
        out[f"grad_{overlap}"] = (gx.numpy(), all_reduce_sum(gw, world)
                                  .numpy(), all_reduce_sum(gb, world).numpy())
    return out


@pytest.fixture(scope="module")
def ranks():
    inp = _inputs()
    res = run_ranks(_ranks, 4, inp, backend="gloo", device="cpu", model=2,
                    timeout_s=120)
    return inp, res


def _jax_same(x, w, b=None):
    # jax is imported here, not at the top: the spawned ranks import this
    # module
    import jax
    import jax.numpy as jnp
    nd = x.ndim - 2
    sp = "DHW"[-nd:]
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        (f"N{sp}C", f"{sp}IO", f"N{sp}C"))
    y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w),
                                     (1,) * nd, "SAME", dimension_numbers=dn)
    return np.asarray(y if b is None else y + b)


def _port_same(x, w, b=None):
    nd = x.ndim - 2
    pads = [((k - 1) // 2, k // 2) for k in w.shape[:nd]]
    y = conv_local(_t(x), _t(w), (1,) * nd, pads)
    return (y if b is None else y + _t(b)).numpy()


@pytest.mark.parametrize("nd", [2, 3])
def test_spatial_conv_matches_the_unsharded_same_conv(ranks, nd):
    """With bias, overlap on and off, against JAX's and the port's
    unsharded SAME conv; every rank gathers the same whole output."""
    inp, res = ranks
    x, w, b = inp[f"x{nd}"], inp[f"w{nd}"], inp[f"b{nd}"]
    for want in (_jax_same(x, w, b), _port_same(x, w, b)):
        for overlap in (True, False):
            np.testing.assert_allclose(res[0][f"sp{nd}_{overlap}"], want,
                                       rtol=TOL, atol=TOL)
    assert np.array_equal(res[0][f"sp{nd}_True"], res[0][f"sp{nd}_False"])
    for r in res[1:]:
        assert np.array_equal(r[f"sp{nd}_True"], res[0][f"sp{nd}_True"])


def test_haloconv_under_ds_matches_the_unsharded_layer(ranks):
    """HaloConv with the ds rules on the (2, 2) mesh (batch over data, H over
    model), plain and with use_pallas (the kernel's plain version here),
    against JAX's SAME conv of the same weights."""
    inp, res = ranks
    r = res[0]
    want = _jax_same(inp["xd"], r["hc_w"], r["hc_b"])
    for pl in (False, True):
        np.testing.assert_allclose(r[f"hc_{pl}"], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["thin", "even", "padding", "p1", "stride"])
def test_halo_edge_cases(ranks, case):
    """``check_halo_edge``'s cases: thin shards raise (H_local = 2 < halo 3
    for k = 7; H_local == halo works; H_local = kh − 1 takes the serial
    branch, an empty interior never reaches the kernel); even kernels split
    their halo asymmetrically (lo = 0); non-SAME padding falls back to the
    plain conv; p = 1 degenerates to the serial conv; strides raise."""
    inp, res = ranks
    r = res[0]
    xe = inp["xe"]
    if case == "thin":
        assert "too thin" in r["thin"], r["thin"]
        np.testing.assert_allclose(r["thin5"], _jax_same(xe, inp["we5"]),
                                   rtol=TOL, atol=TOL)
        for pl in (False, True):
            np.testing.assert_allclose(r[f"edge3_{pl}"],
                                       _jax_same(xe, inp["we3"]),
                                       rtol=TOL, atol=TOL)
    elif case == "even":
        for k in (2, 4):
            for pl in (False, True):
                np.testing.assert_allclose(r[f"edge{k}_{pl}"],
                                           _jax_same(xe, inp[f"we{k}"]),
                                           rtol=TOL, atol=TOL)
    elif case == "padding":
        assert r["valid"].shape == (4, 30, 14, 8)
        assert np.array_equal(r["valid"], r["valid_want"])
    elif case == "p1":
        # one shard on the model axis: the exchange sends nothing and the
        # conv runs on the same tile as the unsharded one
        assert np.array_equal(r["p1"], _port_same(xe, inp["we3"]))
        np.testing.assert_allclose(r["p1"], _jax_same(xe, inp["we3"]),
                                   rtol=TOL, atol=TOL)
    else:
        assert "stride-1 only" in r["stride"], r["stride"]


@pytest.mark.parametrize("overlap", [True, False])
def test_halo_backward_matches_autograd_of_the_unsharded_conv(ranks,
                                                             overlap):
    """Gradients of Σ y·r in x (each rank's block, the returned halo rows'
    gradients added by their owners), w and b (summed over the ranks)
    against autograd of the unsharded conv."""
    inp, res = ranks
    x = _t(inp["x2"]).requires_grad_()
    w = _t(inp["w2"]).requires_grad_()
    b = _t(inp["b2"]).requires_grad_()
    y = conv_local(x, w, (1, 1), [(1, 1), (1, 1)]) + b
    want = torch.autograd.grad((y * _t(inp["r2"])).sum(), (x, w, b))
    for got, ref in zip(res[0][f"grad_{overlap}"], want):
        ref = ref.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
