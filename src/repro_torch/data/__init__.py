from repro_torch.data.pipeline import (SyntheticClassification, SyntheticLM,
                                       TokenDatasetSpec, make_batch)

__all__ = ["SyntheticLM", "SyntheticClassification", "TokenDatasetSpec",
           "make_batch"]
