"""Image-classification models (paddle_tpu/models/image.py): ResNet-50/101/
152 (`resnet_imagenet`, :126) and its blocks (:16-111),
benchmark/paddle/image/resnet.py's layout; the book's CIFAR ResNet
(`_basicblock` :115, `resnet_cifar10` :148); VGG with BN (:162, two
train-mode dropouts); AlexNet (:184, on `lrn`); GoogLeNet (:206-239);
SmallNet (:243) and LeNet (:258). Each takes an NCHW image Variable (or
NHWC where it says so) and returns logits.

Under NHWC training with FLAGS.use_fused_conv (the default) each
bottleneck builds through the fused conv + BN protocol (fused_conv_bn,
bn_stats, bn_apply: ops/fused_conv_ops.py); otherwise through conv2d +
batch_norm. Both name their parameters alike (`_cbn_attrs`), so their
checkpoints interchange.
"""

from __future__ import annotations

from .. import layers
from ..flags import FLAGS
from ..param_attr import ParamAttr

__all__ = ["alexnet", "conv_bn_layer", "googlenet", "lenet", "resnet_cifar10",
           "resnet_imagenet", "smallnet", "vgg"]


def _cbn_attrs(name):
    """Explicit names for a conv + BN pair: conv `{name}.w_0`, BN
    `{name}_bn.{w_0,b_0,mean,variance}`; None names them automatically."""
    if name is None:
        return dict(conv_attr=None, bn_name=None, bn_w=None, bn_b=None)
    return dict(conv_attr=ParamAttr(name=f"{name}.w_0"), bn_name=f"{name}_bn",
                bn_w=ParamAttr(name=f"{name}_bn.w_0"), bn_b=ParamAttr(name=f"{name}_bn.b_0"))


def conv_bn_layer(input, num_filters, filter_size, stride=1, padding=None, act="relu",
                  is_test=False, data_format="NCHW", name=None):
    if padding is None:
        padding = (filter_size - 1) // 2
    a = _cbn_attrs(name)
    conv = layers.conv2d(input, num_filters=num_filters, filter_size=filter_size, stride=stride,
                         padding=padding, bias_attr=False, param_attr=a["conv_attr"],
                         data_format=data_format)
    return layers.batch_norm(conv, act=act, is_test=is_test, param_attr=a["bn_w"],
                             bias_attr=a["bn_b"], name=a["bn_name"], data_format=data_format)


def _shortcut(input, ch_out, stride, is_test, data_format="NCHW", name=None):
    ch_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None, is_test=is_test,
                             data_format=data_format, name=name)
    return input


def _bottleneck(input, ch_out, stride, is_test, data_format="NCHW", name=None):
    if data_format == "NHWC" and not is_test and FLAGS.use_fused_conv:
        return _bottleneck_fused(input, ch_out, stride, name)
    short = _shortcut(input, ch_out * 4, stride, is_test, data_format,
                      name=name and f"{name}_branch1")
    conv1 = conv_bn_layer(input, ch_out, 1, 1, 0, is_test=is_test, data_format=data_format,
                          name=name and f"{name}_branch2a")
    conv2 = conv_bn_layer(conv1, ch_out, 3, stride, 1, is_test=is_test, data_format=data_format,
                          name=name and f"{name}_branch2b")
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None, is_test=is_test,
                          data_format=data_format, name=name and f"{name}_branch2c")
    return layers.relu(layers.elementwise_add(conv3, short))


def _bottleneck_fused(input, ch_out, stride, name=None):
    """The bottleneck through the fused protocol: the projection and the
    two 1x1 convs are fused_conv_bn ops emitting their BN statistics;
    conv3's prologue applies conv2's BN + ReLU, so conv2's output is
    never written normalised."""

    def fused_cbn(x, filters, stride=1, prologue_act="relu", nm=None):
        a = _cbn_attrs(nm)
        return layers.fused_conv_bn(x, filters, stride=stride, prologue_act=prologue_act,
                                    param_attr=a["conv_attr"], bn_param_attr=a["bn_w"],
                                    bn_bias_attr=a["bn_b"], name=a["bn_name"])

    ch_in = input.shape[-1]
    if ch_in != ch_out * 4 or stride != 1:
        short = layers.bn_apply(fused_cbn(input, ch_out * 4, stride=stride,
                                          nm=name and f"{name}_branch1"), act=None)
    else:
        short = input
    conv1 = layers.bn_apply(fused_cbn(input, ch_out, nm=name and f"{name}_branch2a"),
                            act="relu")
    a2 = _cbn_attrs(name and f"{name}_branch2b")
    conv2 = layers.conv2d(conv1, ch_out, 3, stride, 1, bias_attr=False,
                          param_attr=a2["conv_attr"], data_format="NHWC")
    s2 = layers.bn_stats(conv2, param_attr=a2["bn_w"], bias_attr=a2["bn_b"], name=a2["bn_name"])
    conv3 = layers.bn_apply(fused_cbn(s2, ch_out * 4, prologue_act="relu",
                                      nm=name and f"{name}_branch2c"), act=None)
    return layers.relu(layers.elementwise_add(conv3, short))


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False, data_format="NCHW"):
    """ResNet-50/101/152 on an image Variable ([C, H, W], or [H, W, C] for
    NHWC): a 7x7/2 conv + BN, a 3x3/2 max pool, the four stages of
    bottlenecks, a global average pool and an fc to the classes (logits)."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    conv = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test, data_format=data_format,
                         name="conv1")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         data_format=data_format)
    ch = [64, 128, 256, 512]
    for stage, count in enumerate(cfg):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            suffix = chr(97 + i) if i < 26 else f"b{i}"
            pool = _bottleneck(pool, ch[stage], stride, is_test, data_format,
                               name=f"res{stage + 2}{suffix}")
    pool = layers.pool2d(pool, pool_type="avg", global_pooling=True, data_format=data_format)
    return layers.fc(pool, size=class_dim)


def _basicblock(input, ch_out, stride, is_test, data_format="NCHW"):
    short = _shortcut(input, ch_out, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test, data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.relu(layers.elementwise_add(conv2, short))


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """The book's CIFAR ResNet: a 3x3 conv + BN of 16 channels, three
    stages of (depth − 2) / 6 basic blocks of 16, 32 and 64 channels, a
    global average pool and an fc."""
    if (depth - 2) % 6:
        raise ValueError(f"resnet_cifar10: depth {depth} is not 6n + 2")
    n = (depth - 2) // 6
    conv = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    for stage, ch in enumerate([16, 32, 64]):
        for i in range(n):
            conv = _basicblock(conv, ch, 2 if i == 0 and stage > 0 else 1, is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim)


def vgg(input, class_dim=1000, depth=16, is_test=False):
    """VGG-11/13/16/19 with BN (benchmark/paddle/image/vgg.py): five blocks
    of 3x3 conv + BN, each closed by a 2x2 max pool, then two fc 4096 + ReLU
    each followed by dropout 0.5, and the classifier."""
    cfg = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2], 16: [2, 2, 3, 3, 3],
           19: [2, 2, 4, 4, 4]}[depth]
    tmp = input
    for convs, channels in zip(cfg, [64, 128, 256, 512, 512]):
        for _ in range(convs):
            tmp = conv_bn_layer(tmp, channels, 3, 1, 1, is_test=is_test)
        tmp = layers.pool2d(tmp, pool_size=2, pool_stride=2)
    for _ in range(2):
        tmp = layers.fc(tmp, size=4096, act="relu")
        tmp = layers.dropout(tmp, 0.5, is_test=is_test)
    return layers.fc(tmp, size=class_dim)


def alexnet(input, class_dim=1000, is_test=False):
    """benchmark/paddle/image/alexnet.py: conv-lrn-pool twice, three convs,
    a pool, two fc 4096 with dropout, the classifier."""
    t = layers.conv2d(input, 64, 11, stride=4, padding=2, act="relu")
    t = layers.pool2d(layers.lrn(t), pool_size=3, pool_stride=2)
    t = layers.conv2d(t, 192, 5, padding=2, act="relu")
    t = layers.pool2d(layers.lrn(t), pool_size=3, pool_stride=2)
    t = layers.conv2d(t, 384, 3, padding=1, act="relu")
    t = layers.conv2d(t, 256, 3, padding=1, act="relu")
    t = layers.conv2d(t, 256, 3, padding=1, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2)
    for _ in range(2):
        t = layers.fc(t, size=4096, act="relu")
        t = layers.dropout(t, 0.5, is_test=is_test)
    return layers.fc(t, size=class_dim)


def _inception(input, c1, c3r, c3, c5r, c5, proj):
    b1 = layers.conv2d(input, c1, 1, act="relu")
    b3 = layers.conv2d(input, c3r, 1, act="relu")
    b3 = layers.conv2d(b3, c3, 3, padding=1, act="relu")
    b5 = layers.conv2d(input, c5r, 1, act="relu")
    b5 = layers.conv2d(b5, c5, 5, padding=2, act="relu")
    bp = layers.pool2d(input, pool_size=3, pool_stride=1, pool_padding=1)
    bp = layers.conv2d(bp, proj, 1, act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    """benchmark/paddle/image/googlenet.py: Inception v1 without its two
    auxiliary heads, a dropout of 0.4 before the classifier."""
    t = layers.conv2d(input, 64, 7, stride=2, padding=3, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_padding=1)
    t = layers.conv2d(t, 64, 1, act="relu")
    t = layers.conv2d(t, 192, 3, padding=1, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_padding=1)
    t = _inception(t, 64, 96, 128, 16, 32, 32)
    t = _inception(t, 128, 128, 192, 32, 96, 64)
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_padding=1)
    t = _inception(t, 192, 96, 208, 16, 48, 64)
    t = _inception(t, 160, 112, 224, 24, 64, 64)
    t = _inception(t, 128, 128, 256, 24, 64, 64)
    t = _inception(t, 112, 144, 288, 32, 64, 64)
    t = _inception(t, 256, 160, 320, 32, 128, 128)
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_padding=1)
    t = _inception(t, 256, 160, 320, 32, 128, 128)
    t = _inception(t, 384, 192, 384, 48, 128, 128)
    t = layers.pool2d(t, pool_type="avg", global_pooling=True)
    t = layers.dropout(t, 0.4, is_test=is_test)
    return layers.fc(t, size=class_dim)


def smallnet(input, class_dim=10, is_test=False):
    """benchmark/paddle/image/smallnet_mnist_cifar.py, caffe's
    cifar10_quick."""
    t = layers.conv2d(input, 32, 5, padding=2, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2)
    t = layers.conv2d(t, 32, 5, padding=2, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_type="avg")
    t = layers.conv2d(t, 64, 5, padding=2, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_type="avg")
    t = layers.fc(t, size=64, act="relu")
    return layers.fc(t, size=class_dim)


def lenet(input, class_dim=10, is_test=False):
    """The book's recognize_digits conv net."""
    t = layers.conv2d(input, 20, 5, act="relu")
    t = layers.pool2d(t, pool_size=2, pool_stride=2)
    t = layers.conv2d(t, 50, 5, act="relu")
    t = layers.pool2d(t, pool_size=2, pool_stride=2)
    return layers.fc(t, size=class_dim)
