from .actor import AIAActor

__all__ = ["AIAActor"]
