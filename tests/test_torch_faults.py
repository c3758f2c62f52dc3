"""Faults of the port against the JAX package, one case each, on the CPU.

Each case runs the same calls, on the same numpy inputs, through
``mxnet_tpu`` and ``mxnet_tpu_torch`` (``ctx=cpu()``) and compares what
they return: values (float32, 1e-6, the same arithmetic), dtypes, names.
Where the two packages differed the port now follows the JAX package
(ROADMAP.md §3).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

CPU = mxt.cpu()


class _Jax:
    mx = mxj

    @staticmethod
    def array(a, dtype=None):
        return mxj.nd.array(a, dtype=dtype) if dtype else mxj.nd.array(a)

    @staticmethod
    def attach(x):
        x.attach_grad()
        return x

    @staticmethod
    def grad(x):
        return x.grad.asnumpy()

    @staticmethod
    def numpy(x):
        return x.asnumpy()

    @staticmethod
    def dtype(x):
        return np.dtype(x.dtype).name


class _Port:
    mx = mxt

    @staticmethod
    def array(a, dtype=None):
        return mxt.nd.array(a, ctx=CPU, dtype=dtype)

    @staticmethod
    def attach(x):
        return mxt.nd.attach_grad(x)

    @staticmethod
    def grad(x):
        return mxt.nd.asnumpy(mxt.nd.grad(x))

    @staticmethod
    def numpy(x):
        return mxt.nd.asnumpy(x)

    @staticmethod
    def dtype(x):
        return str(x.dtype).replace("torch.", "")


def _grad_of(api, fn, values):
    x = api.attach(api.array(np.asarray(values, np.float32)))
    with api.mx.autograd.record():
        y = fn(x)
    api.mx.autograd.backward([y])
    return [api.numpy(y), api.grad(x)]


def _non_differentiable_op(api):
    """An op registered ``differentiable=False`` passes no gradient."""
    nd = api.mx.nd
    return _grad_of(api, lambda x: nd.sum(nd.topk(x, k=2, ret_typ="value")),
                    [[1.0, 3.0, 2.0]])


def _relu_tie(api):
    """max(x, 0) splits the gradient at x == 0 (``jnp.maximum``), in every
    op that computes it; and min as well."""
    nd = api.mx.nd
    x = [0.0, -1.0, 2.0, 0.5]
    return sum([_grad_of(api, lambda t: (f(t) * w).sum(), x) for f, w in (
        (nd.relu, 1.0),
        (lambda t: nd.Activation(t, act_type="relu"), 2.0),
        (lambda t: nd._maximum_scalar(t, scalar=0.5), 3.0),
        (lambda t: nd._minimum_scalar(t, scalar=0.5), 4.0))], [])


def _abs_at_zero(api):
    return _grad_of(api, lambda t: api.mx.nd.abs(t).sum(), [0.0, -1.0, 2.0])


def _integer_inputs(api):
    """mean, hypot and softrelu of int32 and uint8 arrays compute, in the
    JAX package's dtypes."""
    nd = api.mx.nd
    out = []
    for dtype in ("int32", "uint8"):
        x = api.array(np.array([[1, 2], [3, 4]]), dtype)
        y = api.array(np.array([[2, 0], [1, 5]]), dtype)
        for r in (nd.mean(x), nd.mean(x, axis=1), nd.broadcast_hypot(x, y),
                  nd._hypot_scalar(x, scalar=2.0), nd.softrelu(x)):
            out += [api.numpy(r), api.dtype(r)]
    return out


def _take_wrap(api):
    nd = api.mx.nd
    a = api.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    ids = api.array(np.array([-1.0, 3.0, 4.0, 7.0, 0.0], np.float32))
    return [api.numpy(nd.take(a, ids, mode="wrap")),
            api.numpy(nd.take(a, ids, axis=1, mode="wrap"))]


def _net(api):
    api.mx.random.seed(0)
    nn = api.mx.gluon.nn
    net = nn.HybridSequential(prefix="model_")
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3, prefix="fc1_"),
                nn.Dense(2, in_units=4, prefix="fc2_"))
    net.initialize(ctx=api.mx.cpu())
    return net


def _collect_params_select(api):
    net = _net(api)
    return [sorted(net.collect_params(".*fc2.*").keys()),
            sorted(net.collect_params("model_fc1_w").keys()),
            sorted(net.collect_params().keys())]


def _gluon_methods(api):
    """Parameter.set_data / list_data / reset_ctx and ParameterDict
    zero_grad / setattr / reset_ctx."""
    net = _net(api)
    params = net.collect_params()
    w = params["model_fc1_weight"]
    w.set_data(api.array(np.arange(12, dtype=np.float32).reshape(4, 3)))
    out = [api.numpy(d) for d in w.list_data()]
    x = api.array(np.ones((2, 3), np.float32))
    with api.mx.autograd.record():
        y = net(x).sum()
    y.backward()
    out.append(api.numpy(w.grad()))
    params.zero_grad()
    out += [api.numpy(p.grad()) for p in params.values()]
    params.reset_ctx(api.mx.cpu())
    w.reset_ctx(api.mx.cpu())
    out += [api.numpy(net(x)), api.numpy(w.data())]
    params.setattr("grad_req", "null")
    out.append([p.grad_req for p in params.values()])
    return out


def _sort_axis_none(api):
    """``sort`` and ``argsort`` with ``axis=None`` work on the flattened
    input, ascending and descending."""
    nd = api.mx.nd
    x = api.array(np.random.RandomState(3).normal(size=(3, 4)).astype(
        np.float32))
    return [api.numpy(f(x, axis=None, is_ascend=asc))
            for f in (nd.sort, nd.argsort) for asc in (True, False)]


def _backward_on_a_vector(api):
    """F1: ``head.backward()`` on a head of more than one element seeds
    ones (``NDArray.backward``), as ``loss.backward()`` on a Gluon loss's
    per-sample vector needs."""
    x = api.attach(api.array(np.array([1.0, -2.0, 3.0], np.float32)))
    with api.mx.autograd.record():
        y = x * 2
    y.backward()
    out = [api.numpy(y), api.grad(x)]
    net = _net(api)
    data = api.array(np.random.RandomState(0).normal(size=(4, 3)).astype(
        np.float32))
    label = api.array(np.array([[1, 0], [0, 1], [1, 1], [0, 0]], np.float32))
    loss_fn = api.mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    with api.mx.autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    out.append(api.numpy(loss))
    out += [api.numpy(p.grad()) for p in net.collect_params().values()]
    return out


def _hypot_at_zero(api):
    """F2: hypot's gradient at (0, 0) is 0.5 for each input (``jnp.hypot``
    takes a max of the two magnitudes, whose tie splits)."""
    nd = api.mx.nd
    a = api.attach(api.array(np.array([0.0, 3.0, 0.0], np.float32)))
    b = api.attach(api.array(np.array([0.0, -4.0, -2.0], np.float32)))
    c = api.attach(api.array(np.array([0.0, 1.0], np.float32)))
    with api.mx.autograd.record():
        y = nd.broadcast_hypot(a, b).sum() + nd._hypot(a, b).sum() + \
            nd._hypot_scalar(c, scalar=0.0).sum()
    y.backward()
    return [api.grad(a), api.grad(b), api.grad(c)]


def _power_zero_to_the_zero(api):
    """F3: power's gradient in the base at 0 ** 0 is NaN (y * x ** (y - 1),
    as upstream MXNet's backward gives); torch.pow's is 0."""
    nd = api.mx.nd
    a = api.attach(api.array(np.array([0.0, 0.0, 2.0, 0.0], np.float32)))
    b = api.attach(api.array(np.array([0.0, 2.0, 0.0, 1.0], np.float32)))
    c = api.attach(api.array(np.array([0.0, 3.0], np.float32)))
    with api.mx.autograd.record():
        y = nd.broadcast_power(a, b).sum() + nd._power_scalar(c, scalar=0.0).sum()
    y.backward()
    return [api.grad(a), api.grad(b), api.grad(c)]


def _cbrt_at_zero(api):
    """F4: cbrt's gradient at 0 is +inf, rcbrt's -inf (``jnp.cbrt``)."""
    nd = api.mx.nd
    out = []
    for f in (nd.cbrt, nd.rcbrt):
        x = api.attach(api.array(np.array([0.0, -8.0, 27.0], np.float32)))
        with api.mx.autograd.record():
            y = f(x).sum()
        y.backward()
        out += [api.grad(x)]
    return out


def _conv_transpose_deferred_channels(api):
    """A Conv2DTranspose with no ``in_channels``, run eagerly: its weight
    takes the input's channels (100, from a (4, 100, 1, 1) latent), not
    the batch size."""
    api.mx.random.seed(0)
    nn = api.mx.gluon.nn
    net = nn.Sequential(prefix="g_")
    with net.name_scope():
        net.add(nn.Conv2DTranspose(6, 4, 1, 0, use_bias=False))
        net.add(nn.Conv2D(3, 3, 1, 1))
    net.initialize(api.mx.init.Normal(0.02), ctx=api.mx.cpu())
    z = api.array(np.random.RandomState(1).normal(size=(4, 100, 1, 1)).astype(
        np.float32))
    out = net(z)
    return [api.numpy(out)] + [api.numpy(p.data())
                               for p in net.collect_params().values()]


def _nd_keywords_out_and_numpy(api):
    """F6: the generated ``nd`` functions take tensors by input name, write
    ``out=``, and convert numpy arrays (on the current context)."""
    nd = api.mx.nd
    rs = np.random.RandomState(0)
    x, w, b = (rs.normal(size=s).astype(np.float32)
               for s in ((2, 3), (4, 3), (4,)))
    fc = nd.FullyConnected(data=api.array(x), weight=api.array(w),
                           bias=api.array(b), num_hidden=4)
    a = api.array(x)
    o = api.array(np.zeros((2, 3), np.float32))
    ret = nd.elemwise_add(a, a, out=o)
    with api.mx.cpu():
        relu = nd.relu(x)
        badd = nd.broadcast_add(x, b[:3].reshape(1, 3))
        dot = nd.dot(x, w.T)
    return [api.numpy(fc), api.numpy(o), ret is o, api.numpy(relu),
            api.numpy(badd), api.numpy(dot)]


def _checkpoint_dir_env(api):
    """F7: with ``MXNET_CHECKPOINT_DIR`` set, ``do_checkpoint`` and
    ``module_checkpoint`` save through the managed directory, not to
    prefix files."""
    mx = api.mx
    sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2, name="fc")
    rs = np.random.RandomState(0)
    arg = {"fc_weight": api.array(rs.normal(size=(2, 3)).astype(np.float32)),
           "fc_bias": api.array(np.zeros(2, np.float32))}
    with tempfile.TemporaryDirectory() as tmp:
        root, pre = os.path.join(tmp, "managed"), os.path.join(tmp, "pre")
        os.makedirs(pre)
        old = os.environ.get("MXNET_CHECKPOINT_DIR")
        os.environ["MXNET_CHECKPOINT_DIR"] = root
        try:
            mx.callback.do_checkpoint(os.path.join(pre, "m"))(0, sym, arg,
                                                              {})
            mx.checkpoint.env_manager().wait()
        finally:
            if old is None:
                del os.environ["MXNET_CHECKPOINT_DIR"]
            else:
                os.environ["MXNET_CHECKPOINT_DIR"] = old
        return [sorted(n for n in os.listdir(root) if n.startswith("step_")),
                sorted(os.listdir(pre))]


def _public_names(api):
    """F8: the JAX package's public names the port lacked, each present
    and, where callable, giving the same result."""
    mx = api.mx
    x = api.array(np.ones((2, 3), np.float32))
    sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2, name="fc")
    ex = sym.simple_bind(mx.cpu(), data=(2, 3))
    with mx.AttrScope(group="a"):
        scope_attr = dict(mx.attribute.AttrScope.current()._attr)
    init = mx.init.Uniform(0.1)
    with mx.cpu():
        batch = mx.gluon.data.dataloader.default_mp_batchify_fn(
            [np.ones(2, np.float32), np.zeros(2, np.float32)])
    return [isinstance(x, mx.nd.NDArray), mx.NDArray is mx.nd.NDArray,
            mx.Optimizer is mx.optimizer.Optimizer,
            mx.KVStore is mx.kvstore.KVStore,
            mx.Monitor is mx.monitor.Monitor, mx.mon is mx.monitor,
            mx.NameManager is mx.name.NameManager,
            str(mx.context.cpu_pinned()), str(mx.context.cpu_pinned(1)),
            isinstance(mx.context.num_gpus(), int),
            sym.get_children().list_outputs(),
            mx.sym.var("v").get_children() is None, sym.debug_str(),
            ex.debug_str(), scope_attr,
            init.set_verbosity(True) is init, api.numpy(batch)]


def _signed_zero(api):
    """F9: ``rcbrt(-0.0)`` is -inf; the gradients of ``gamma`` and
    ``gammaln`` at ±0 are NaN (``jsp.gammaln``'s digamma)."""
    nd = api.mx.nd
    out = [api.numpy(nd.rcbrt(api.array(np.array([-0.0, 0.0, -8.0],
                                                  np.float32))))]
    for f in (nd.gamma, nd.gammaln):
        x = api.attach(api.array(np.array([-0.0, 0.0, 1.5, -2.5],
                                          np.float32)))
        with api.mx.autograd.record():
            y = f(x).sum()
        y.backward()
        out += [api.grad(x)]
    return out


_CASES = [_non_differentiable_op, _relu_tie, _abs_at_zero, _integer_inputs,
          _take_wrap, _collect_params_select, _gluon_methods,
          _sort_axis_none, _backward_on_a_vector, _hypot_at_zero,
          _power_zero_to_the_zero, _cbrt_at_zero,
          _conv_transpose_deferred_channels, _nd_keywords_out_and_numpy,
          _checkpoint_dir_env, _public_names, _signed_zero]


@pytest.mark.parametrize("case", _CASES, ids=[c.__name__[1:] for c in _CASES])
def test_fault_repaired_matches_jax(case):
    want = case(_Jax)
    got = case(_Port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            assert g == w


def test_torch_maximum_splits_ties_as_jax():
    """The ReLU repair rests on torch.maximum's gradient at a tie: half to
    each side, as jnp.maximum's."""
    x = torch.tensor([0.0, -1.0, 2.0], requires_grad=True)
    torch.maximum(x, torch.tensor(0.0)).sum().backward()
    want = jax.grad(lambda t: jnp.maximum(t, 0.0).sum())(
        jnp.asarray([0.0, -1.0, 2.0], jnp.float32))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


def test_reset_ctx_refuses_an_invisible_gpu():
    """reset_ctx moves data as .to(device) does: to a CUDA device this
    process cannot see it raises, and the data stays where it was."""
    net = _net(_Port)
    w = net.collect_params()["model_fc1_weight"]
    with pytest.raises(mxt.MXNetError):
        w.reset_ctx(mxt.context.Context("gpu", 64))
    assert w.data().device.type == "cpu"
