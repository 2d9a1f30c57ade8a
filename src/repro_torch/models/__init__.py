from .model import LM, RuntimeKnobs

__all__ = ["LM", "RuntimeKnobs"]
