"""Offline FID CLI: folder vs folder.

The port's counterpart of `sgdm_tpu/eval/fid_cli.py`; prints the same JSON
(``fid`` and `get_fid_dict`'s keys):

    python -m sgdm_tpu_torch.eval.fid_cli DIR1 DIR2 [--debug] [--batch-size N] \\
        [--weights PTH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from .fid_engine import InceptionExtractor, get_fid_dict


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description="FID between two image folders")
    p.add_argument("dir1", help="sample dir")
    p.add_argument("dir2", help="reference dir")
    p.add_argument("--debug", action="store_true", help="skip fid_tf and IS (the bilinear pass)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--weights", default=None,
                   help="pt_inception .pth (else SGDM_INCEPTION_WEIGHTS)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    ex = InceptionExtractor(weights_path=a.weights, batch_size=a.batch_size, device=a.device)
    out, fid = get_fid_dict(a.dir1, a.dir2, ex, debug=a.debug)
    result = {"fid": fid, **out}
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
