"""The FLOP counter and the roofline copy against counts worked by hand."""
import torch

from portbench import flops, roofline
from portbench.reference.dit import DiT
from portbench.reference.sd import AutoencoderKL


def test_dit_forward_counts_every_product_and_its_attention():
    b, size, p, d, depth, heads, c = 2, 8, 2, 64, 2, 4, 4
    with torch.device("meta"):
        model = DiT(size, p, c, d, depth, heads, num_classes=10, learn_sigma=False)
    n = b * (size // p) ** 2  # tokens
    patch = 2 * n * d * c * p * p
    t_mlp = 2 * b * (256 * d + d * d)
    block = 2 * b * d * 6 * d + 2 * n * d * (3 * d + d + 4 * d + 4 * d)
    attn = 4 * b * heads * (n // b) ** 2 * (d // heads)
    final = 2 * b * d * 2 * d + 2 * n * d * p * p * c
    got = flops.count(model, torch.zeros(b, c, size, size), torch.zeros(b, dtype=torch.long),
                      torch.zeros(b, dtype=torch.long))
    assert got.flops == patch + t_mlp + depth * (block + attn) + final
    assert got.attention == [(f"blocks.{i}.attend", (b, heads, 16, 16, d // heads))
                             for i in range(depth)]


def test_vae_decode_counts_its_mid_block_attention():
    with torch.device("meta"):
        vae = AutoencoderKL(ch=32, ch_mult=[1, 2], num_res_blocks=1)
    got = flops.count(vae, torch.zeros(1, 4, 4, 4), method="decode")
    hw, ch = 16, 64  # the latent grid and the widest level, where the mid block runs
    assert got.attention == [("decoder.mid.attn_1.attend", (1, 1, hw, hw, ch))]
    convs = (2 * 4 * 4 * hw                        # post_quant_conv, 1x1
             + 2 * ch * 4 * 9 * hw                 # conv_in
             + 4 * 2 * ch * ch * 9 * hw            # the mid block's two resnets
             + 4 * 2 * ch * ch * hw                # q, k, v, proj_out
             + 4 * 2 * ch * ch * 9 * hw            # level 1: two resnets
             + 2 * ch * ch * 9 * 4 * hw            # its upsample, at 8x8
             + 2 * ch * 32 * 9 * 4 * hw + 2 * 32 * 32 * 9 * 4 * hw + 2 * ch * 32 * 4 * hw
             + 2 * 2 * 32 * 32 * 9 * 4 * hw        # level 0's second resnet
             + 2 * 32 * 3 * 9 * 4 * hw)            # conv_out
    assert got.flops == convs + 4 * hw * hw * ch
    assert len(got.group_norm) == 2 * 2 + 1 + 2 * 2 * 2 + 1


def test_roofline_of_hand_worked_shapes():
    # K1 at SD1.5's first level, b32: 8 heads, 4096 queries and keys, d 40
    ops, nbytes = roofline.attention_fwd_work(32, 8, 4096, 4096, 40)
    assert ops == 4 * 32 * 8 * 4096 * 4096 * 40
    assert nbytes == 2 * 32 * 8 * 40 * (2 * 4096 + 2 * 4096) + 4 * 32 * 8 * 4096
    ms, bound = roofline.bound_ms(ops, nbytes)
    assert bound == "operations" and abs(ms - 1e3 * ops / 989e12) < 1e-12
    # K2 at DiT-XL/2's, b64: 16 heads, 256 tokens, d 72
    ops, nbytes = roofline.attention_bwd_work(64, 16, 256, 256, 72)
    assert ops == 10 * 64 * 16 * 256 * 256 * 72
    assert nbytes == 2 * 64 * 16 * 72 * 8 * 256 + 4 * 64 * 16 * 256
    # K3 on the VAE's last level, f32, with SiLU: one read and one write
    ops, nbytes = roofline.group_norm_work(16, 128, 512 * 512, 4)
    assert (ops, nbytes) == (16 * 128 * 512 * 512 * 10, 2 * 16 * 128 * 512 * 512 * 4)
    assert roofline.bound_ms(ops, nbytes)[1] == "bytes"
