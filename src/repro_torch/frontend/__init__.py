from repro_torch.frontend.keras2plan import Keras2Plan, generate_dml

__all__ = ["Keras2Plan", "generate_dml"]
