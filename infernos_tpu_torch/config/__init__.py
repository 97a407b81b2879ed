from .validator import ConfigParseError, validate, validate_yaml
from .config import InfernConfig

__all__ = ["ConfigParseError", "validate", "validate_yaml", "InfernConfig"]
