from .backbone_explicit_depth import BackboneExplicitDepthCfg
from .backbone_midas import BackboneMidasCfg
from .registry import BackboneCfg, init_backbone

__all__ = ["BackboneCfg", "BackboneExplicitDepthCfg", "BackboneMidasCfg", "init_backbone"]
