from . import role_maker
from .fleet_base import DistributedOptimizer, Fleet

__all__ = ["role_maker", "Fleet", "DistributedOptimizer"]
