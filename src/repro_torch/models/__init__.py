"""The models of the PyTorch port (counterpart of ``repro.models``).

``Model`` and ``build_model`` load on first use: the flash attention
kernel's plain version lives in ``models.attention``, and importing the
whole model here would import that kernel's package back."""


def __getattr__(name):
    if name in ("Model", "build_model"):
        from repro_torch.models import model

        return getattr(model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Model", "build_model"]
