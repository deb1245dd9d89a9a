"""What the two configurations read does not hang on where the harness
keeps their family's layout and formulas: each weight's path, shape,
type, draw and scale in draw order, a tiny dense model's drawn bits, and
the FLOP counts and least times the metrics take, pinned as literals read
from the harness before the family modules."""
import hashlib

import pytest
import torch

from portbench.lib import runner, spec

BENCH = spec.benchmark()
BF16 = torch.bfloat16

LAYOUTS = {
    "granite-34b": [
        (("embed",), (49152, 6144), BF16, "normal", 0.02),
        (("final_norm",), (6144,), BF16, "ones", 0.0),
        (("layers", "attn", "wk"), (88, 6144, 128), BF16, "normal",
         0.01275775907699572),
        (("layers", "attn", "wo"), (88, 6144, 6144), BF16, "normal",
         0.01275775907699572),
        (("layers", "attn", "wq"), (88, 6144, 6144), BF16, "normal",
         0.01275775907699572),
        (("layers", "attn", "wv"), (88, 6144, 128), BF16, "normal",
         0.01275775907699572),
        (("layers", "ln1"), (88, 6144), BF16, "ones", 0.0),
        (("layers", "ln2"), (88, 6144), BF16, "ones", 0.0),
        (("layers", "mlp", "wd"), (88, 24576, 6144), BF16, "normal",
         0.00637887953849786),
        (("layers", "mlp", "wu"), (88, 6144, 24576), BF16, "normal",
         0.01275775907699572),
        (("lm_head",), (6144, 49152), BF16, "normal", 0.01275775907699572),
    ],
    "musicgen-selfattn-2.4b": [
        (("embed",), (2048, 2048), BF16, "normal", 0.02),
        (("final_norm",), (2048,), BF16, "ones", 0.0),
        (("frontend_proj",), (128, 2048), BF16, "normal",
         0.08838834764831845),
        (("layers", "attn", "wk"), (48, 2048, 2048), BF16, "normal",
         0.02209708691207961),
        (("layers", "attn", "wo"), (48, 2048, 2048), BF16, "normal",
         0.02209708691207961),
        (("layers", "attn", "wq"), (48, 2048, 2048), BF16, "normal",
         0.02209708691207961),
        (("layers", "attn", "wv"), (48, 2048, 2048), BF16, "normal",
         0.02209708691207961),
        (("layers", "ln1"), (48, 2048), BF16, "ones", 0.0),
        (("layers", "ln2"), (48, 2048), BF16, "ones", 0.0),
        (("layers", "mlp", "wd"), (48, 8192, 2048), BF16, "normal",
         0.011048543456039806),
        (("layers", "mlp", "wu"), (48, 2048, 8192), BF16, "normal",
         0.02209708691207961),
        (("lm_head",), (2048, 2048), BF16, "normal", 0.02209708691207961),
    ],
}

#: (config, B, S): mfu.prefill's and mfu.train's FLOPs, the least seconds
#: of attn_roofline.prefill, of attn_roofline.train's forwards and its
#: backwards
COUNTS = [
    ("granite-34b", 8, 1024, 555610659618816, 1681660890316800,
     0.009180818300505562, 0.009180818300505562, 0.022952045751263903),
    ("granite-34b", 1, 8192, 619103228264448, 1872151279828992,
     0.07338384813272396, 0.07338384813272396, 0.1834596203318099),
    ("musicgen-selfattn-2.4b", 3, 2048, 32161948237824, 96646830489600,
     0.0025026381416056623, 0.0025026381416056623, 0.006256595354014157),
    ("musicgen-selfattn-2.4b", 12, 512, 30306597863424, 91080552873984,
     0.0014423397635820894, 0.0014536080429850746, 0.002895947806567164),
]

#: sha256 over each leaf's path and bf16 bits of the tiny model below
TINY_DIGEST = \
    "b4e5eaf244eafe24cea5c7671ffc6324e909f16b398985bcb791cdd0c3c35df6"


def model(name):
    return spec.model(spec.load_config(BENCH, name))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_in_draw_order(name):
    got = [(l.path, l.shape, l.dtype, l.init, l.std)
           for l in spec.layout(model(name))]
    assert got == LAYOUTS[name]


def test_tiny_dense_weights_keep_their_bits():
    m = model("musicgen-selfattn-2.4b")
    m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, frontend_dim=8,
             mlp_type="swiglu")
    h = hashlib.sha256()
    for k, t in spec.leaves(spec.make_weights(m, 2**31 + 17, "cpu")):
        h.update(k.encode())
        h.update(t.view(torch.int16).numpy().tobytes())
    assert h.hexdigest() == TINY_DIGEST


@pytest.mark.parametrize("name,B,S,prefill,train,fwd,fwd_lse,bwd", COUNTS)
def test_flops_and_least_times(name, B, S, prefill, train, fwd, fwd_lse,
                               bwd):
    m = model(name)

    def fn(metric, f):
        return runner.load_metric(metric).__globals__[f]
    assert fn("mfu.prefill", "flops")(m, B, S) == prefill
    assert fn("mfu.train", "flops")(m, B, S) == train
    assert fn("attn_roofline.prefill", "least_seconds")(m, B, S) == fwd
    assert fn("attn_roofline.train", "least_seconds")(m, B, S) == fwd_lse
    assert fn("attn_roofline.train", "least_backward_seconds")(m, B, S) \
        == bwd
