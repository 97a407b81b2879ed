from .base import GenCodec
from .g711 import G711Codec, G711ACodec
