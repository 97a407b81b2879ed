from .actor import LTActor

__all__ = ["LTActor"]
