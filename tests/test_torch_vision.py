"""The vision path of the port against the JAX package, on the CPU.

Per op, the same numpy inputs go through ``mxnet_tpu``'s op and the
port's (``ctx=cpu()``): the outputs, the gradients of a scalar loss
(a fixed random weighting of the first output, summed) and, for
BatchNorm, the moving statistics it writes back, at 1e-4 in float32.
Then the port alone reproduces the seven vision goldens; one SGD-momentum
step of a small hybridized CNN matches the JAX package's (loss, every
gradient, updated weights, moving statistics); a hybridized
``resnet18_v1`` has the JAX package's graph JSON byte for byte; and a
``.params`` file moves between the packages either way.  The entry points
raise ``MXNetError`` where no CUDA device is and no ``cpu()`` was asked.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu

CPU = mxt.cpu()
TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _np(x):
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else \
        mxt.nd.asnumpy(x)


class _Jax:
    mx = mxj

    @staticmethod
    def array(a):
        return mxj.nd.array(a)

    @staticmethod
    def attach(x):
        x.attach_grad()
        return x

    @staticmethod
    def grad(x):
        return x.grad.asnumpy()


class _Port:
    mx = mxt

    @staticmethod
    def array(a):
        return mxt.nd.array(a, ctx=CPU)

    @staticmethod
    def attach(x):
        return mxt.nd.attach_grad(x)

    @staticmethod
    def grad(x):
        # an input the op never reads (gamma under fix_gamma) has no
        # gradient buffer in torch; the JAX package gives zeros
        g = mxt.nd.grad(x)
        return np.zeros(tuple(x.shape), np.float32) if g is None else \
            mxt.nd.asnumpy(g)


def _op_run(api, op, shapes, kwargs, aux=(), train=True, seed=0):
    """Run ``op`` on random inputs of ``shapes`` under record(); returns
    [first output, d loss / d each non-aux input, each aux input after]."""
    rs = np.random.RandomState(seed)
    arrays = [rs.normal(size=s).astype(np.float32) for s in shapes]
    for i in aux:       # moving variances must be positive
        arrays[i] = np.abs(arrays[i]) + 0.5
    xs = [api.array(a) for a in arrays]
    grads = [i for i in range(len(xs)) if i not in aux]
    for i in grads:
        api.attach(xs[i])
    with api.mx.autograd.record(train_mode=train):
        out = getattr(api.mx.nd, op)(*xs, **kwargs)
        first = out[0] if isinstance(out, list) else out
    # the loss sum(first * cot), through its head gradient cot
    cot = api.array(rs.normal(size=tuple(first.shape)).astype(np.float32))
    api.mx.autograd.backward([first], [cot])
    return ([_np(first)] + [api.grad(xs[i]) for i in grads]
            + [_np(xs[i]) for i in aux])


_BN = ((2, 3, 4, 4), (3,), (3,), (3,), (3,))
_OP_CASES = {
    "conv2d_groups_dilate_stride": (
        "Convolution", [(2, 4, 8, 8), (6, 2, 3, 3), (6,)],
        dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
             num_filter=6, num_group=2), {}),
    "conv1d": ("Convolution", [(2, 3, 9), (4, 3, 3), (4,)],
               dict(kernel=(3,), pad=(1,), num_filter=4), {}),
    "conv3d_no_bias": ("Convolution", [(1, 2, 5, 5, 5), (3, 2, 3, 3, 3)],
                       dict(kernel=(3, 3, 3), stride=(2, 2, 2), num_filter=3,
                            no_bias=True), {}),
    "deconv_groups_adj": ("Deconvolution", [(2, 4, 5, 5), (4, 3, 3, 3), (6,)],
                          dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               adj=(1, 0), num_filter=6, num_group=2,
                               no_bias=False), {}),
    "deconv_dilate": ("Deconvolution", [(1, 3, 4, 4), (3, 2, 2, 2)],
                      dict(kernel=(2, 2), dilate=(2, 2), num_filter=2,
                           target_shape=(9, 9)), {}),
    "pool_max_valid_pad": ("Pooling", [(2, 3, 9, 9)],
                           dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), {}),
    "pool_max_full": ("Pooling", [(2, 3, 8, 8)],
                      dict(kernel=(3, 3), stride=(2, 2),
                           pooling_convention="full"), {}),
    "pool_avg_full_pad": ("Pooling", [(2, 3, 8, 8)],
                          dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               pool_type="avg", pooling_convention="full"), {}),
    "pool_avg_wide_pad": ("Pooling", [(2, 3, 7, 7)],
                          dict(kernel=(2, 2), stride=(1, 1), pad=(2, 2),
                               pool_type="avg"), {}),
    "pool_sum_valid": ("Pooling", [(2, 3, 7, 7)],
                       dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            pool_type="sum"), {}),
    "pool_max_1d": ("Pooling", [(2, 3, 10)],
                    dict(kernel=(3,), stride=(2,), pooling_convention="full"),
                    {}),
    "pool_global_max": ("Pooling", [(2, 3, 5, 5)],
                        dict(global_pool=True, kernel=(1, 1)), {}),
    "pool_global_avg": ("Pooling", [(2, 3, 5, 5)],
                        dict(global_pool=True, pool_type="avg"), {}),
    "pool_global_sum": ("Pooling", [(2, 3, 5, 5)],
                        dict(global_pool=True, pool_type="sum"), {}),
    "batchnorm_train": ("BatchNorm", _BN,
                        dict(fix_gamma=False, eps=1e-5, momentum=0.8),
                        dict(aux=(3, 4))),
    "batchnorm_train_fix_gamma": ("BatchNorm", _BN, dict(),
                                  dict(aux=(3, 4))),
    "batchnorm_train_axis3": ("BatchNorm", ((2, 4, 4, 3),) + _BN[1:],
                              dict(fix_gamma=False, axis=3),
                              dict(aux=(3, 4))),
    "batchnorm_eval": ("BatchNorm", _BN, dict(fix_gamma=False),
                       dict(aux=(3, 4), train=False)),
    "batchnorm_global_stats": ("BatchNorm", _BN,
                               dict(fix_gamma=False, use_global_stats=True),
                               dict(aux=(3, 4))),
    "instancenorm": ("InstanceNorm", [(2, 3, 4, 5), (3,), (3,)], dict(), {}),
    "lrn": ("LRN", [(2, 5, 3, 3)], dict(nsize=3, alpha=0.1, beta=0.5), {}),
    "leaky": ("LeakyReLU", [(2, 3, 4)], dict(act_type="leaky", slope=0.1), {}),
    "elu": ("LeakyReLU", [(2, 3, 4)], dict(act_type="elu", slope=0.3), {}),
    "prelu": ("LeakyReLU", [(2, 3, 4, 4), (3,)], dict(act_type="prelu"), {}),
    "selu": ("LeakyReLU", [(2, 3, 4)], dict(act_type="selu"), {}),
    "upsampling_nearest": ("UpSampling", [(2, 3, 3, 4)],
                           dict(scale=2, sample_type="nearest"), {}),
    "upsampling_bilinear": ("UpSampling", [(1, 2, 3, 4)],
                            dict(scale=3, sample_type="bilinear"), {}),
    "flatten": ("Flatten", [(2, 3, 2, 2)], dict(), {}),
}


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_op_matches_jax(case):
    op, shapes, kwargs, extra = _OP_CASES[case]
    want = _op_run(_Jax, op, shapes, kwargs, **extra)
    got = _op_run(_Port, op, shapes, kwargs, **extra)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_batchnorm_bf16_keeps_float32_statistics():
    """bf16 data, bf16 parameters: the output stays bf16, the statistics
    are taken in float32 and the moving mean is the float32 update
    rounded once to bf16."""
    import torch
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.normal(1.0, 2.0, (4, 3, 5, 5)), dtype=torch.bfloat16)
    gamma, beta = torch.ones(3, dtype=torch.bfloat16), \
        torch.zeros(3, dtype=torch.bfloat16)
    mm = torch.full((3,), 0.5, dtype=torch.bfloat16)
    mv = torch.ones(3, dtype=torch.bfloat16)
    with mxt.autograd.train_mode():
        out = mxt.nd.BatchNorm(x, gamma, beta, mm, mv, fix_gamma=False)[0]
    assert out.dtype == torch.bfloat16
    mean = x.float().mean(dim=(0, 2, 3))
    var = x.float().var(dim=(0, 2, 3), unbiased=False)
    assert torch.equal(mm, (0.5 * 0.9 + mean * 0.1).to(torch.bfloat16))
    assert torch.equal(mv, (0.9 + var * 0.1).to(torch.bfloat16))


def test_dropout_training():
    """Inverted dropout from the port's generator: a seed fixes the mask,
    about 1 - p of the values are kept and scaled by 1 / (1 - p);
    inference is the identity unless mode="always"."""
    x = mxt.nd.array(np.ones((200, 100), np.float32), ctx=CPU)
    p = 0.3
    masks = []
    for _ in range(2):
        mxt.random.seed(7)
        with mxt.autograd.train_mode():
            masks.append(mxt.nd.asnumpy(mxt.nd.Dropout(x, p=p)))
    np.testing.assert_array_equal(masks[0], masks[1])
    kept = masks[0] != 0
    assert abs(kept.mean() - (1 - p)) < 0.02
    np.testing.assert_allclose(masks[0][kept], 1 / (1 - p), rtol=1e-6)
    with mxt.autograd.train_mode():
        other = mxt.nd.asnumpy(mxt.nd.Dropout(x, p=p))
    assert (other != masks[0]).any()
    np.testing.assert_array_equal(mxt.nd.asnumpy(mxt.nd.Dropout(x, p=p)),
                                  np.ones((200, 100), np.float32))
    always = mxt.nd.asnumpy(mxt.nd.Dropout(x, p=p, mode="always"))
    assert (always == 0).any()
    # one mask value per row along the shared axis
    with mxt.autograd.train_mode():
        rows = mxt.nd.asnumpy(mxt.nd.Dropout(x, p=p, axes=(1,)))
    assert all(len(set(r)) == 1 for r in rows)


_GOLDEN_SHAPES = {"resnet18_v1": (2, 3, 64, 64), "resnet18_v2": (2, 3, 64, 64),
                  "mobilenet0_25": (2, 3, 64, 64),
                  "squeezenet1_0": (2, 3, 64, 64),
                  "densenet121": (1, 3, 224, 224),
                  "inception_v3": (1, 3, 299, 299),
                  "alexnet": (2, 3, 224, 224)}


def golden_case(name, ctx):
    """The JAX package's golden case (``mxnet_tpu/test_utils.py``) built
    with the port: seed 0, Xavier gaussian 'in' magnitude 2, inputs from
    RandomState(42); returns (net, input)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mxt.random.seed(0)
    net = getattr(vision, name)()
    net.initialize(mxt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), ctx=ctx)
    rs = np.random.RandomState(42)
    x = mxt.nd.array(rs.normal(0, 1, _GOLDEN_SHAPES[name]).astype(np.float32),
                     ctx=ctx)
    return net, x


@pytest.mark.parametrize("name", sorted(_GOLDEN_SHAPES))
def test_golden_vision(name):
    """The port alone reproduces the committed logits at the fixture's own
    1e-4; no JAX code runs."""
    net, x = golden_case(name, CPU)
    got = mxt.nd.asnumpy(net(x))
    want = np.load(os.path.join(GOLDEN, f"{name}.npz"))["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _small_net(mx):
    """conv-BN-relu-maxpool, a residual block with a downsample, global
    average pooling and a Dense layer, hybridized."""
    from importlib import import_module
    nn = mx.gluon.nn
    resnet = import_module(mx.__name__ + ".gluon.model_zoo.vision.resnet")
    net = nn.HybridSequential(prefix="smallcnn_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(3, 2, 1),
                resnet.BasicBlockV1(16, 2, downsample=True, in_channels=8),
                nn.GlobalAvgPool2D(), nn.Dense(5))
    net.hybridize()
    return net


def _train_step(api, net, x, y):
    mx = api.mx
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mx.autograd.backward([loss])
    params = net.collect_params()
    grads = {n[len(net.prefix):]: _np(p.grad()) for n, p in params.items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    after = {n[len(net.prefix):]: _np(p.data()) for n, p in params.items()}
    return _np(loss), grads, after


def test_one_training_step_matches_jax():
    rs = np.random.RandomState(0)
    xs = rs.normal(size=(2, 3, 16, 16)).astype(np.float32)
    ys = np.array([1, 3], np.float32)
    mxj.random.seed(0)
    jnet = _small_net(mxj)
    jnet.initialize(mxj.init.Xavier(rnd_type="gaussian", magnitude=2))
    jnet(mxj.nd.array(xs))
    tnet = _small_net(mxt)
    tnet.initialize(ctx=CPU)
    params_from_mxnet_tpu({n: p.data().asnumpy()
                           for n, p in jnet.collect_params().items()}, tnet)
    want = _train_step(_Jax, jnet, mxj.nd.array(xs), mxj.nd.array(ys))
    got = _train_step(_Port, tnet, mxt.nd.array(xs, ctx=CPU),
                      mxt.nd.array(ys, ctx=CPU))
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    assert sorted(got[1]) == sorted(want[1])
    assert not any("running" in n for n in got[1])
    for part in (1, 2):
        for name, w in want[part].items():
            np.testing.assert_allclose(got[part][name], w, rtol=TOL,
                                       atol=TOL, err_msg=name)
    # the moving statistics moved, in both
    moved = [n for n in want[2] if "running_mean" in n]
    assert moved and all(np.abs(want[2][n]).max() > 0 for n in moved)


def test_graph_json_and_aux_states_match_jax():
    jnet = mxj.gluon.model_zoo.vision.resnet18_v1(prefix="resnetv10_")
    tnet = mxt.gluon.model_zoo.vision.resnet18_v1(prefix="resnetv10_")
    jsym = jnet(mxj.sym.var("data"))
    tsym = tnet(mxt.sym.var("data"))
    assert tsym.tojson() == jsym.tojson()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.list_arguments() == jsym.list_arguments()
    assert len(tsym.list_auxiliary_states()) == 2 * 20
    shapes = tsym.infer_shape(data=(1, 3, 32, 32))
    assert shapes == jsym.infer_shape(data=(1, 3, 32, 32))
    types = tsym.infer_type(data="bfloat16")
    assert [[str(t) for t in part] for part in types] == \
        [[str(t) for t in part] for part in jsym.infer_type(data="bfloat16")]


def test_params_files_move_between_packages(tmp_path):
    """A JAX ``resnet18_v1``'s ``.params`` file loads into the port and
    gives the same logits, and the reverse, moving statistics included
    (set away from their initial values first)."""
    x = np.random.RandomState(5).normal(size=(1, 3, 32, 32)).astype(
        np.float32)
    mxj.random.seed(0)
    jnet = mxj.gluon.model_zoo.vision.resnet18_v1(classes=10)
    jnet.initialize(mxj.init.Xavier())
    jnet(mxj.nd.array(x))
    rs = np.random.RandomState(6)
    for n, p in jnet.collect_params().items():
        if "running" in n:
            p.set_data(mxj.nd.array(rs.uniform(0.5, 1.5, p.shape).astype(
                np.float32)))
    jnet.save_params(str(tmp_path / "jax.params"))
    tnet = mxt.gluon.model_zoo.vision.resnet18_v1(classes=10)
    tnet.load_parameters(str(tmp_path / "jax.params"), ctx=CPU)
    want = jnet(mxj.nd.array(x)).asnumpy()
    np.testing.assert_allclose(_np(tnet(mxt.nd.array(x, ctx=CPU))), want,
                               rtol=TOL, atol=TOL)
    # the reverse: the JAX package reads the port's file back into the
    # very values it wrote, so its logits are the ones above
    tnet.save_parameters(str(tmp_path / "port.params"))
    jnet2 = mxj.gluon.model_zoo.vision.resnet18_v1(classes=10)
    jnet2.load_params(str(tmp_path / "port.params"))
    mine = {n[len(jnet.prefix):]: p.data().asnumpy()
            for n, p in jnet.collect_params().items()}
    back = {n[len(jnet2.prefix):]: p.data().asnumpy()
            for n, p in jnet2.collect_params().items()}
    assert sorted(back) == sorted(mine)
    for n, v in mine.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)


def test_entry_points_raise_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    net = mxt.gluon.model_zoo.vision.get_model("resnet18_v1")
    with pytest.raises(MXNetError):
        net.initialize()
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(MXNetError):
        trainer.step(1)
    data = mxt.gluon.data.ArrayDataset(np.zeros((4, 3), np.float32))
    with pytest.raises(MXNetError):
        next(iter(mxt.gluon.data.DataLoader(data, batch_size=2)))
