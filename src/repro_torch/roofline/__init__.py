"""The cost models (the port of ``repro.roofline``): the three-term
roofline and the bucket auto-tune on the H100's constants
(:mod:`.analysis`), and the per-device memory model
(:mod:`.memory_model`). The records they read come from
``repro_torch.launch.dryrun``."""
from repro_torch.roofline.analysis import (HW_H100, analyze_record,
                                           format_table, model_flops,
                                           roofline_terms)

__all__ = ["HW_H100", "analyze_record", "format_table", "model_flops",
           "roofline_terms"]
