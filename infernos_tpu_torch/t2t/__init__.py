from .numbers import NumbersToWords
from .translator import Translator
from .sentences import sent_split, regroup_sentences

__all__ = ["NumbersToWords", "Translator", "sent_split", "regroup_sentences"]
