from .catre_loss import LossConfig, angular_distance_rot, catre_loss
from .pm_loss import pm_loss

__all__ = ["LossConfig", "angular_distance_rot", "catre_loss", "pm_loss"]
