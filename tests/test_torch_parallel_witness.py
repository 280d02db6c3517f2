"""A witness of the reference's semantics, which the port's sharded CNNs copy:
the JAX package's smoke ResNet SGD step under the data, filter and ds rules
on a (2, 2) mesh of 4 virtual host devices gives the gradients of its
unsharded step. In particular its BatchNorm reduces over the whole batch and
image (GSPMD keeps ``jnp.mean``'s unsharded meaning and inserts the
all-reduce), though ``repro/nn/layers.py``'s docstring calls BatchNorm local
under data parallelism (that is the paper's cost model, §4.5.2); a local
BatchNorm would move these gradients by far more than the bar.

The check runs in a subprocess (``python <this file>``) with XLA_FLAGS set
for 4 host devices, as the JAX package's multi-device checks do, on the
smoke ResNet at batch 8, 32 px, as ``test_torch_parallel_train.py``. Bars:
the loss within 1e-5 relative, as the port's; the gradients within 3e-3 in
relative L2 over the whole model and 1e-2 per tensor. The port's 1e-4
does not hold for the reference itself: XLA's CPU BatchNorm statistics
drift in the last bits (ROADMAP caveat e), which reads 1.7e-3 under data
and ds (4.2e-3 in the worst tensor) and 6e-6 under filter. A BatchNorm
local to each device's 2 images, planted as the alternative, moves the
loss by 8.8 % and the gradients by 48 in relative L2, and must fail.
"""
import os
import subprocess
import sys
from pathlib import Path

STRATEGIES = ("data", "filter", "ds")


def _check():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.data.pipeline import DataConfig, SyntheticSource
    from repro.launch.compat import make_mesh
    from repro.models.cnn import ResNet, ResNetConfig
    from repro.nn.module import NULL_CTX, ShardingCtx, tree_init
    from repro.parallel.strategies import make_rules
    assert len(jax.devices()) == 4, jax.devices()
    model = ResNet(ResNetConfig("resnet50-smoke", (1, 1, 1, 1), n_classes=10))
    params = tree_init(model.params_spec(), jax.random.PRNGKey(0))
    batch = SyntheticSource(DataConfig("image", 8, image=32,
                                       classes=10)).batch_at(0)
    mesh = make_mesh((2, 2), ("data", "model"))

    def step(ctx):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss_fn(p, b, ctx)[0]))(params, batch)
        return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]

    def rel_l2(got):
        num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, grads))
        return (num / sum(float(np.sum(b ** 2)) for b in grads)) ** 0.5

    loss, grads = step(NULL_CTX)
    for s in STRATEGIES:
        l_s, g_s = step(ShardingCtx(mesh, make_rules(s)))
        errs = [np.linalg.norm(a - b) / np.linalg.norm(b)
                for a, b in zip(g_s, grads)]
        print(f"{s}: loss {l_s!r} (unsharded {loss!r}), gradients relative "
              f"L2 {rel_l2(g_s):.3g}, worst tensor {max(errs):.3g}")
        assert abs(l_s - loss) <= 1e-5 * abs(loss), (s, l_s, loss)
        assert rel_l2(g_s) <= 3e-3, (s, rel_l2(g_s))
        assert max(errs) <= 1e-2, (s, max(errs))
    # the planted alternative: BatchNorm local to each data shard of 2
    # (the mean of the four shards' losses) must fail the same bars
    l_l, g_l = jax.jit(jax.value_and_grad(lambda p, b: jnp.mean(jnp.stack([
        model.loss_fn(p, {k: v[2 * i:2 * i + 2] for k, v in b.items()},
                      NULL_CTX)[0] for i in range(4)]))))(params, batch)
    g_l = [np.asarray(g) for g in jax.tree.leaves(g_l)]
    print(f"local BatchNorm: loss {float(l_l)!r}, gradients relative L2 "
          f"{rel_l2(g_l):.3g}")
    assert abs(float(l_l) - loss) > 1e-3 * abs(loss) and rel_l2(g_l) > 0.1
    print("WITNESS-PASSED")


def test_reference_sharded_step_equals_its_unsharded_step():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, __file__], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "WITNESS-PASSED" in out.stdout, out.stdout + out.stderr[-3000:]


if __name__ == "__main__":
    _check()
