"""``fused_phase1_quant``'s share of its roofline in the traced window:
the frozen work model's least time a launch over the device time of its
``score_fold_kernel<QuantScorer>`` and ``merge_splits_kernel``."""

from portbench.roofline.share import roofline_pct


def read(run):
    return roofline_pct(run, "fused_phase1_quant")
