"""The paper's own CNN workloads as kernel lists (paper §4.3 / Table 1).

A copy of ``repro.core.cnn_workloads``.  These classes have no Pallas kernel
in the JAX package and so no CUDA kernel in the port: they stay analytical
(TPU targets only), and :class:`~repro_torch.core.measured_runner.MeasuredRunner`
refuses them.

TPU adaptation: a convolution lowers onto the MXU as an implicit GEMM
(im2col), so each conv kernel becomes a matmul-family instance with
M = B·OH·OW, N = C_out, K = C_in·KH·KW — the schedule space (BlockSpec
tiles, order, staging) and the v5e cost model apply unchanged.  This lets
us reproduce the paper's ResNet18 ← ResNet50 experiment *literally* (same
kernel classes, same layer shapes) inside the same transfer-tuning core
the LM architectures use.

ResNet18's kernel table below is transcribed from paper Table 1 (18
kernels, 6 classes A–F); ResNet50/other models are built from their
published layer configurations.
"""
from __future__ import annotations

from repro_torch.core.workload import KernelInstance, KernelUse, dedup_uses


def _conv(class_id: str, cin: int, cout: int, k: int, hw: int, stride: int = 1,
          count: int = 1, batch: int = 1, tag: str = "") -> KernelUse:
    ohw = hw // stride
    return KernelUse(
        KernelInstance.make(class_id, M=batch * ohw * ohw, N=cout, K=cin * k * k),
        use_count=count, tag=tag or f"{class_id}_{cin}x{cout}k{k}s{stride}",
    )


def _dense(cin: int, cout: int, batch: int = 1, count: int = 1) -> KernelUse:
    return KernelUse(KernelInstance.make("dense_add", M=batch, N=cout, K=cin),
                     use_count=count, tag=f"dense_{cin}x{cout}")


def _pool(class_id: str, c: int, hw: int, k: int, count: int = 1, batch: int = 1) -> KernelUse:
    return KernelUse(
        KernelInstance.make(class_id, M=batch * (hw // k) * (hw // k), N=c, K=k * k),
        use_count=count, tag=f"{class_id}_{c}",
    )


def resnet18(batch: int = 1) -> list[KernelUse]:
    """Paper Table 1, verbatim kernel census (classes A–F)."""
    b = batch
    return dedup_uses([
        # class A: conv2d_add (strided downsample shortcuts)
        _conv("conv2d_add", 256, 512, 1, 14, 2, 1, b),
        _conv("conv2d_add", 128, 256, 1, 28, 2, 1, b),
        _conv("conv2d_add", 64, 128, 1, 56, 2, 1, b),
        # class E: conv2d_bias_relu
        _conv("conv2d_bias_relu", 3, 64, 7, 224, 2, 1, b),
        _conv("conv2d_bias_relu", 64, 64, 3, 56, 1, 2, b),
        _conv("conv2d_bias_relu", 64, 128, 3, 56, 2, 1, b),
        _conv("conv2d_bias_relu", 128, 128, 3, 28, 1, 1, b),
        _conv("conv2d_bias_relu", 128, 256, 3, 28, 2, 1, b),
        _conv("conv2d_bias_relu", 256, 256, 3, 14, 1, 1, b),
        _conv("conv2d_bias_relu", 256, 512, 3, 14, 2, 1, b),
        _conv("conv2d_bias_relu", 512, 512, 3, 7, 1, 1, b),
        # class F: conv2d_bias_add_relu (residual-add fused)
        _conv("conv2d_bias_add_relu", 64, 64, 3, 56, 1, 2, b),
        _conv("conv2d_bias_add_relu", 128, 128, 3, 28, 1, 2, b),
        _conv("conv2d_bias_add_relu", 256, 256, 3, 14, 1, 2, b),
        _conv("conv2d_bias_add_relu", 512, 512, 3, 7, 1, 2, b),
        # classes B/C: pooling; class D: classifier
        _pool("max_pool2d", 64, 112, 2, 1, b),
        _pool("global_avg_pool2d", 512, 7, 7, 1, b),
        _dense(512, 1000, b),
    ])


def resnet50(batch: int = 1) -> list[KernelUse]:
    """Bottleneck-block census (1x1-reduce / 3x3 / 1x1-expand per block)."""
    b = batch
    uses: list[KernelUse] = [
        _conv("conv2d_bias_relu", 3, 64, 7, 224, 2, 1, b),
        _pool("max_pool2d", 64, 112, 2, 1, b),
    ]
    stages = [  # (cin, cmid, cout, hw, blocks)
        (64, 64, 256, 56, 3),
        (256, 128, 512, 28, 4),
        (512, 256, 1024, 14, 6),
        (1024, 512, 2048, 7, 3),
    ]
    for cin, cmid, cout, hw, blocks in stages:
        stride = 1 if cin == 64 else 2
        in_hw = hw * stride
        uses += [
            _conv("conv2d_add", cin, cout, 1, in_hw, stride, 1, b),        # shortcut
            _conv("conv2d_bias_relu", cin, cmid, 1, in_hw, stride, 1, b),  # first reduce
            _conv("conv2d_bias_relu", cout, cmid, 1, hw, 1, blocks - 1, b),
            _conv("conv2d_bias_relu", cmid, cmid, 3, hw, 1, blocks, b),
            _conv("conv2d_bias_add_relu", cmid, cout, 1, hw, 1, blocks, b),
        ]
    uses += [_pool("global_avg_pool2d", 2048, 7, 7, 1, b), _dense(2048, 1000, b)]
    return dedup_uses(uses)


def alexnet(batch: int = 1) -> list[KernelUse]:
    b = batch
    return dedup_uses([
        _conv("conv2d_bias_relu", 3, 64, 11, 224, 4, 1, b),
        _conv("conv2d_bias_relu", 64, 192, 5, 27, 1, 1, b),
        _conv("conv2d_bias_relu", 192, 384, 3, 13, 1, 1, b),
        _conv("conv2d_bias_relu", 384, 256, 3, 13, 1, 1, b),
        _conv("conv2d_bias_relu", 256, 256, 3, 13, 1, 1, b),
        _pool("max_pool2d", 64, 55, 2, 1, b),
        _pool("max_pool2d", 192, 27, 2, 1, b),
        _pool("max_pool2d", 256, 13, 2, 1, b),
        _dense(9216, 4096, b), _dense(4096, 4096, b), _dense(4096, 1000, b),
    ])


def vgg16(batch: int = 1) -> list[KernelUse]:
    b = batch
    uses = []
    cfg = [(3, 64, 224, 2), (64, 128, 112, 2), (128, 256, 56, 3),
           (256, 512, 28, 3), (512, 512, 14, 3)]
    for cin, cout, hw, n in cfg:
        uses.append(_conv("conv2d_bias_relu", cin, cout, 3, hw, 1, 1, b))
        if n > 1:
            uses.append(_conv("conv2d_bias_relu", cout, cout, 3, hw, 1, n - 1, b))
        uses.append(_pool("max_pool2d", cout, hw, 2, 1, b))
    uses += [_dense(25088, 4096, b), _dense(4096, 4096, b), _dense(4096, 1000, b)]
    return dedup_uses(uses)


CNN_MODELS = {
    "resnet18": resnet18,
    "resnet50": resnet50,
    "alexnet": alexnet,
    "vgg16": vgg16,
}


def cnn_uses(name: str, batch: int = 1) -> list[KernelUse]:
    return CNN_MODELS[name](batch)
