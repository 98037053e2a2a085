"""The unfolded FID InceptionV3 with pytorch-fid's ``pt_inception`` key names.

The port's copy of `sgdm_tpu/eval/torch_inception_ref.py`: conv + BatchNorm
(eps 1e-3) + ReLU modules named as in ``pt_inception-2015-12-05-6726825d.pth``,
so that file loads into it as it is.  It is the ground truth for the folded
network `eval.inception.FIDInceptionV3`: `utils.weight_verify` loads a real
checkpoint into both and holds their ``pool3`` together.  Its ``spatial``
output flattens the 7 channels CHW (pytorch-fid's order), the folded
network's NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as tnn
import torch.nn.functional as F

__all__ = ["TFIDInception"]


class TConvBN(tnn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = tnn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class TInceptionA(tnn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = TConvBN(cin, 64, kernel_size=1)
        self.branch5x5_1 = TConvBN(cin, 48, kernel_size=1)
        self.branch5x5_2 = TConvBN(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = TConvBN(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = TConvBN(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = TConvBN(96, 96, kernel_size=3, padding=1)
        self.branch_pool = TConvBN(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg(x))
        return torch.cat([b1, b5, bd, bp], 1)


class TInceptionB(tnn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = TConvBN(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = TConvBN(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = TConvBN(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = TConvBN(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2),
        ], 1)


class TInceptionC(tnn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = TConvBN(cin, 192, kernel_size=1)
        self.branch7x7_1 = TConvBN(cin, c7, kernel_size=1)
        self.branch7x7_2 = TConvBN(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = TConvBN(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = TConvBN(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = TConvBN(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = TConvBN(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = TConvBN(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = TConvBN(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = TConvBN(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(
            self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(_avg(x))
        return torch.cat([b1, b7, bd, bp], 1)


class TInceptionD(tnn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = TConvBN(cin, 192, kernel_size=1)
        self.branch3x3_2 = TConvBN(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = TConvBN(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = TConvBN(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = TConvBN(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = TConvBN(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3_2(self.branch3x3_1(x)),
            self.branch7x7x3_4(self.branch7x7x3_3(
                self.branch7x7x3_2(self.branch7x7x3_1(x)))),
            F.max_pool2d(x, 3, stride=2),
        ], 1)


class TInceptionE(tnn.Module):
    def __init__(self, cin, use_max_pool=False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = TConvBN(cin, 320, kernel_size=1)
        self.branch3x3_1 = TConvBN(cin, 384, kernel_size=1)
        self.branch3x3_2a = TConvBN(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = TConvBN(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = TConvBN(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = TConvBN(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = TConvBN(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = TConvBN(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = TConvBN(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.use_max_pool:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], 1)


class TFIDInception(tnn.Module):
    """pytorch-fid's FID InceptionV3 rebuilt on core torch (same key names)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = TConvBN(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = TConvBN(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = TConvBN(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = TConvBN(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = TConvBN(80, 192, kernel_size=3)
        self.Mixed_5b = TInceptionA(192, 32)
        self.Mixed_5c = TInceptionA(256, 64)
        self.Mixed_5d = TInceptionA(288, 64)
        self.Mixed_6a = TInceptionB(288)
        self.Mixed_6b = TInceptionC(768, 128)
        self.Mixed_6c = TInceptionC(768, 160)
        self.Mixed_6d = TInceptionC(768, 160)
        self.Mixed_6e = TInceptionC(768, 192)
        self.Mixed_7a = TInceptionD(768)
        self.Mixed_7b = TInceptionE(1280)
        self.Mixed_7c = TInceptionE(2048, use_max_pool=True)
        self.fc = tnn.Linear(2048, 1008)

    def forward(self, x):
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Mixed_5b(x)
        x = self.Mixed_5c(x)
        x = self.Mixed_5d(x)
        x = self.Mixed_6a(x)
        x = self.Mixed_6b(x)
        x = self.Mixed_6c(x)
        x = self.Mixed_6d(x)
        x = self.Mixed_6e(x)
        spatial = x[:, :7].reshape(x.shape[0], -1)
        x = self.Mixed_7a(x)
        x = self.Mixed_7b(x)
        x = self.Mixed_7c(x)
        pool3 = x.mean(dim=(2, 3))
        return pool3, self.fc(pool3), spatial
