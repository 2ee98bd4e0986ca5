"""models/resnet.py against the JAX package's ResNet trunks: a
torchvision-layout state dict (seeded weights, BN statistics away from the
identity) through each package's convert_torch_trunk, then trunk_forward
of ResNet-50 (3 channels) and ResNet-18 (5 channels, XMem's value
encoder) on the same seeded input; the f4 / f8 / f16 features agree
within 1e-5 of their scale (f32 convolutions summed in another order)."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_xmem_pair import one_torch_thread
from video_llava_tpu.models import resnet as jres
from video_llava_tpu_torch.models import resnet as tres
from video_llava_tpu_torch.models.layers import TreeInit


def torchvision_state_dict(tree, rng, prefix=""):
    """The port's trunk tree -> torchvision's names (conv*.weight,
    bn*.{weight,bias,running_mean,running_var}, downsample.0 / .1), the
    BN statistics redrawn away from the identity."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = p["weight"]

    def bn(name, p):
        c = p["scale"].shape
        for key, lo, hi in (("weight", 0.8, 1.2), ("bias", -0.1, 0.1),
                            ("running_mean", -0.1, 0.1),
                            ("running_var", 0.7, 1.3)):
            sd[f"{name}.{key}"] = torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32))

    conv(f"{prefix}conv1", tree["conv1"])
    bn(f"{prefix}bn1", tree["bn1"])
    for li in range(1, 4):
        for bi, blk in enumerate(tree[f"layer{li}"]):
            b = f"{prefix}layer{li}.{bi}"
            for k, v in blk.items():
                if k.startswith("conv"):
                    conv(f"{b}.{k}", v)
                elif k.startswith("bn"):
                    bn(f"{b}.{k}", v)
            if "downsample" in blk:
                conv(f"{b}.downsample.0", blk["downsample"]["conv"])
                bn(f"{b}.downsample.1", blk["downsample"]["bn"])
    return sd


@one_torch_thread()
def test_trunks_match_jax():
    rng = np.random.default_rng(0)
    for make, cin in (("resnet50", 3), ("resnet18", 5)):
        jcfg = getattr(jres.ResNetTrunkConfig, make)(in_channels=cin)
        tcfg = getattr(tres.ResNetTrunkConfig, make)(in_channels=cin)
        assert tcfg.out_channels == jcfg.out_channels
        tree = tres.init_trunk_params(TreeInit(1, "cpu"), tcfg)
        sd = torchvision_state_dict(tree, rng, prefix="enc.")
        jp = jres.convert_torch_trunk(sd, jcfg, prefix="enc.")
        tp = tres.convert_torch_trunk(sd, tcfg, prefix="enc.")
        x = rng.normal(size=(2, 64, 96, cin)).astype(np.float32)
        want = jres.trunk_forward(jp, jnp.asarray(x), jcfg)
        got = tres.trunk_forward(tp, torch.from_numpy(x).permute(0, 3, 1, 2),
                                 tcfg)
        for stride, g, w in zip((4, 8, 16), got, want):
            w = np.moveaxis(np.asarray(w), -1, 1)
            assert g.shape == w.shape == (2, g.shape[1], 64 // stride,
                                          96 // stride), (make, stride)
            err = np.abs(g.numpy() - w).max() / np.abs(w).max()
            assert err < 1e-5, (make, stride, err)
