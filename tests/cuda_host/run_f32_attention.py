"""Child process of tests/test_torch_attention_f32_host.py: runs K9's f32
kernels, built for the host (``libf32_attention_host.so``), on seeded
operands at each shape given and saves operands and results with
`torch.save`.  A separate process, so that the test can bound its time
(a kernel that loops for ever, say); a deadlock at the barriers comes back
as an error.

    python run_f32_attention.py LIB OUT B,H,N,D [B,H,N,D ...]
"""

import ctypes
import sys

import torch


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bnhd(b, h, n, d):
    """A NaN-filled [B, H, N, D] view of a [B, N, H, D] tensor, as the wrappers allocate."""
    return torch.full((b, n, h, d), float("nan")).permute(0, 2, 1, 3)


def main(lib_path: str, out_path: str, shapes: list[tuple[int, ...]]) -> None:
    lib = ctypes.CDLL(lib_path)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides_t = ctypes.POINTER(ctypes.c_longlong)
    lib.host_attention_f32.argtypes = [vp] * 4 + [i] * 4 + [strides_t, f, vp]
    lib.host_attention_bwd_f32.argtypes = [vp] * 10 + [i] * 4 + [strides_t, f]
    results = {}
    for b, h, n, d in shapes:
        scale = (1.0 / d ** 0.25) ** 2
        gen = torch.Generator().manual_seed(n + d)
        # the classifier's operands are views of its packed [B, N, 3, H, D] projection
        q, k, v = torch.randn(b, n, 3, h, d, generator=gen).permute(2, 0, 3, 1, 4)
        do = torch.randn(b, h, n, d, generator=gen)

        def forward(with_lse):
            out = _bnhd(b, h, n, d)
            lse = torch.full((b, h, n), float("nan")) if with_lse else None
            st = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
            assert lib.host_attention_f32(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, h, n, d, st,
                                          scale, _ptr(lse)) == 0
            return out, lse

        def backward(out, lse):
            grads = tuple(_bnhd(b, h, n, d) for _ in range(3))
            dr = torch.full((b, h, n), float("nan"))
            ops = (q, k, v, out, do) + grads
            st = (ctypes.c_longlong * 24)(*(s for t in ops for s in t.stride()[:3]))
            assert lib.host_attention_bwd_f32(*(_ptr(t) for t in ops[:5]), _ptr(lse), _ptr(dr),
                                              *(_ptr(t) for t in grads), b, h, n, d, st,
                                              scale) == 0
            return grads, dr

        out, lse = forward(True)
        k3, _ = forward(False)
        grads, dr = backward(out, lse)
        again, _ = backward(out, lse)
        results[(b, h, n, d)] = dict(q=q, k=k, v=v, do=do, out=out, lse=lse, k3=k3,
                                     grads=grads, dr=dr, again=again)
    torch.save(results, out_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], [tuple(map(int, s.split(","))) for s in sys.argv[3:]])
