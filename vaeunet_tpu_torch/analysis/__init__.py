"""Uncertainty analysis and its figures.  Port of ``vaeunet_tpu/analysis``."""

from vaeunet_tpu_torch.analysis.analyze import AnalyzeArgs, analyze_model
from vaeunet_tpu_torch.analysis import plots

__all__ = ["AnalyzeArgs", "analyze_model", "plots"]
