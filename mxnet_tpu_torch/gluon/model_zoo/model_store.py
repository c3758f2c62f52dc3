"""Model zoo file store (parity: python/mxnet/gluon/model_zoo/model_store.py).

The reference downloads `{name}-{sha1[:8]}.params` from the Apache S3
bucket.  Here `get_model_file` resolves ONLY against a local root (default
`~/.mxnet/models`, override with `MXNET_HOME` or `root=`) and never
downloads: pre-placed or converted checkpoints with the reference naming
slot straight in, and a missing file raises an actionable error.  The
sha1 table is the port's own copy of the JAX package's, so cache file
names match the reference exactly.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "purge"]

# name -> sha1 (reference model_store.py table; kept for cache naming)
_model_sha1 = {name: checksum for checksum, name in [
    ('44335d1f0046b328243b32a26a4fbd62d9057b45', 'alexnet'),
    ('f27dbf2dbd5ce9a80b102d89c7483342cd33cb31', 'densenet121'),
    ('b6c8a95717e3e761bd88d145f4d0a214aaa515dc', 'densenet161'),
    ('2603f878403c6aa5a71a124c4a3307143d6820e9', 'densenet169'),
    ('1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb', 'densenet201'),
    ('ed47ec45a937b656fcc94dabde85495bbef5ba1f', 'inceptionv3'),
    ('d2b128fa89477c2e20061607a53a8d9f66ce239d', 'resnet101_v1'),
    ('6562166cd597a6328a32a0ce47bb651df80b3bbb', 'resnet152_v1'),
    ('38d6d423c22828718ec3397924b8e116a03e6ac0', 'resnet18_v1'),
    ('4dc2c2390a7c7990e0ca1e53aeebb1d1a08592d1', 'resnet34_v1'),
    ('2a903ab21260c85673a78fe65037819a843a1f43', 'resnet50_v1'),
    ('8aacf80ff4014c1efa2362a963ac5ec82cf92d5b', 'resnet18_v2'),
    ('0ed3cd06da41932c03dea1de7bc2506ef3fb97b3', 'resnet34_v2'),
    ('eb7a368774aa34a12ed155126b641ae7556dad9d', 'resnet50_v2'),
    ('264ba4970a0cc87a4f15c96e25246a1307caf523', 'squeezenet1.0'),
    ('33ba0f93753c83d86e1eb397f38a667eaf2e9376', 'squeezenet1.1'),
    ('dd221b160977f36a53f464cb54648d227c707a05', 'vgg11'),
    ('ee79a8098a91fbe05b7a973fed2017a6117723a8', 'vgg11_bn'),
    ('6bc5de58a05a5e2e7f493e2d75a580d83efde38c', 'vgg13'),
    ('7d97a06c3c7a1aecc88b6e7385c2b373a249e95e', 'vgg13_bn'),
    ('649467530119c0f78c4859999e264e7bf14471a9', 'vgg16'),
    ('6b9dbe6194e5bfed30fd7a7c9a71f7e5a276cb14', 'vgg16_bn'),
    ('f713436691eee9a20d70a145ce0d53ed24bf7399', 'vgg19'),
    ('9730961c9cea43fd7eeefb00d792e386c45847d6', 'vgg19_bn'),
    ('b55eb6327e1c1d8db398b11e193dd1d0e6d78779', 'mobilenet0.25'),
    ('a3bdcbcbe1e40c1d2969aa2a0f0dd92a0a1b2a0c', 'mobilenet0.5'),
    ('cb10ca05ae25a4942bf103dd09eb8c80a2f0b2f6', 'mobilenet0.75'),
    ('e392fe05eec9ec5f0692a8b0c1bd4e9c3b155dd1', 'mobilenet1.0')]}


def short_hash(name: str) -> str:
    if name not in _model_sha1:
        raise MXNetError(f"Pretrained model for {name} is not available.")
    return _model_sha1[name][:8]


def default_root() -> str:
    return os.path.join(os.environ.get("MXNET_HOME",
                                       os.path.expanduser("~/.mxnet")),
                        "models")


def get_model_file(name: str, root: str = None) -> str:
    """Return the local path of the pretrained parameter file
    `{name}-{sha1[:8]}.params` (also accepts plain `{name}.params`).

    Unlike the reference, no download is attempted: place converted
    reference checkpoints under `root` (default `$MXNET_HOME/models` or
    `~/.mxnet/models`).
    """
    root = os.path.expanduser(root or default_root())
    candidates = [os.path.join(root, f"{name}-{short_hash(name)}.params"),
                  os.path.join(root, f"{name}.params")]
    for path in candidates:
        if os.path.exists(path):
            return path
    raise MXNetError(
        f"Pretrained weights for '{name}' not found locally (looked for "
        f"{candidates}). Nothing is downloaded: convert or copy the "
        f"reference checkpoint into place, e.g. "
        f"`cp {name}.params {candidates[0]}`.")


def purge(root: str = None) -> None:
    """Remove cached pretrained files (parity: model_store.purge)."""
    root = os.path.expanduser(root or default_root())
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
