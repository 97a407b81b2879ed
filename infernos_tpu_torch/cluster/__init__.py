from .actors import Actor, ActorHandle, spawn

__all__ = ["Actor", "ActorHandle", "spawn"]
