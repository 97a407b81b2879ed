from .base import GenCodec
from .g711 import G711Codec, G711ACodec
from .g722 import G722Codec

#: Payload-type -> codec class map used by SDP negotiation and by the
#: ingest ring's payload-type discipline.
CODECS = {c.ptype: c for c in (G711Codec, G711ACodec, G722Codec)}

__all__ = ["GenCodec", "G711Codec", "G711ACodec", "G722Codec", "CODECS"]
