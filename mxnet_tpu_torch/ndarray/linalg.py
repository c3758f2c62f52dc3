"""`mx.nd.linalg` namespace (parity: python/mxnet/ndarray/linalg.py over
src/operator/tensor/la_op.cc): the ``linalg_*`` ops, batched over leading
axes."""
from .register import invoke


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0):
    return invoke("linalg_gemm", [A, B, C],
                  dict(transpose_a=transpose_a, transpose_b=transpose_b,
                       alpha=alpha, beta=beta))


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    return invoke("linalg_gemm2", [A, B],
                  dict(transpose_a=transpose_a, transpose_b=transpose_b,
                       alpha=alpha))


def potrf(A):
    return invoke("linalg_potrf", [A], {})


def potri(A):
    return invoke("linalg_potri", [A], {})


def trsm(A, B, transpose=False, rightside=False, alpha=1.0):
    return invoke("linalg_trsm", [A, B],
                  dict(transpose=transpose, rightside=rightside, alpha=alpha))


def trmm(A, B, transpose=False, rightside=False, alpha=1.0):
    return invoke("linalg_trmm", [A, B],
                  dict(transpose=transpose, rightside=rightside, alpha=alpha))


def sumlogdiag(A):
    return invoke("linalg_sumlogdiag", [A], {})


def syrk(A, transpose=False, alpha=1.0):
    return invoke("linalg_syrk", [A], dict(transpose=transpose, alpha=alpha))
