from .selection import ArticulationView, match_labels

__all__ = ["ArticulationView", "match_labels"]
