from .mesh import make_mesh, replicate, shard_tts_state

__all__ = ["make_mesh", "shard_tts_state", "replicate"]
