"""The port's registry defaults beside the JAX package's, where they
differ on purpose.

`lrn_maxpool`: the port defaults to `fused` (K4 forward, K5 backward on
every adjacent LRN -> max-pool pair); the JAX package defaults to
`composed` (veles_tpu/ops/variants.py:327-329) and reaches a fused point
only when its kernel search (ops/templates.py) selects one. The port has
no search yet, so its default keeps K4 and K5 on the main path; the
registry entry's doc says so. Both lowerings meet the same golden
(tests/test_torch_kernels.py, tests/test_torch_train_step.py).

`conv_stem`: the port defaults to `direct` (cuDNN at the layer's
stride); the JAX package defaults to `s2d` (veles_tpu/ops/variants.py:
339-363), the space-to-depth rewrite its TPU measurement chose. Both
lowerings compute the same convolution (tests/test_torch_conv_stem.py);
on the card the choice waits for a benchmark cell.
"""

from veles_tpu.ops import variants as jvariants
from veles_tpu_torch.ops import variants


def test_lrn_maxpool_default_is_fused_where_the_reference_composes():
    assert variants._OPS["lrn_maxpool"].default == "fused"
    assert jvariants._OPS["lrn_maxpool"].default == "composed"
    prev = variants.selected("lrn_maxpool")
    variants.clear_selection("lrn_maxpool")
    try:
        assert variants.resolve("lrn_maxpool").name == "fused"
        assert variants.resolve("lrn_maxpool").fused
    finally:
        if prev is not None:
            variants.select("lrn_maxpool", prev)
    doc = variants._OPS["lrn_maxpool"].doc
    assert "composed" in doc and "veles_tpu/ops/variants.py" in doc


def test_conv_stem_default_is_direct_where_the_reference_packs():
    assert variants._OPS["conv_stem"].default == "direct"
    assert jvariants._OPS["conv_stem"].default == "s2d"
    prev = variants.selected("conv_stem")
    variants.clear_selection("conv_stem")
    try:
        assert variants.resolve("conv_stem").name == "direct"
    finally:
        if prev is not None:
            variants.select("conv_stem", prev)
    doc = variants._OPS["conv_stem"].doc
    assert "s2d" in doc and "veles_tpu/ops/variants.py" in doc
