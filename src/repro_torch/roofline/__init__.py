"""Roofline model of the port (counterpart of ``repro.roofline``): the
analytic FLOP/byte/collective model, the roofline terms on H100 peaks,
and the dry-run report."""

from repro_torch.roofline.analysis import HW, roofline_terms, summarize_cost

__all__ = ["HW", "roofline_terms", "summarize_cost"]
