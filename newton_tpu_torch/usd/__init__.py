"""USD layer (port of ``newton_tpu/usd``): the text parser, the binary
crate codec and the importer's schema resolvers under one module path."""

from ..utils.import_usd import (
    MjcSchemaResolver,
    NewtonSchemaResolver,
    PhysxSchemaResolver,
    SchemaResolver,
    SchemaResolverManager,
    parse_usd,
)
from ..utils.usda_parser import UsdaPrim, parse_usda
from .usdc import is_usdc, read_usdc, write_usdc

__all__ = ["MjcSchemaResolver", "NewtonSchemaResolver", "PhysxSchemaResolver",
           "SchemaResolver", "SchemaResolverManager", "UsdaPrim", "is_usdc",
           "parse_usd", "parse_usda", "read_usdc", "write_usdc"]
