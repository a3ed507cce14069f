"""Dataset loaders for the datasets bundled with the package (Chickenpox,
PedalMe, England Covid, Montevideo bus, Twitter tennis)."""

from .chickenpox import ChickenpoxDatasetLoader
from .encovid import EnglandCovidDatasetLoader
from .montevideo_bus import MontevideoBusDatasetLoader
from .pedalme import PedalMeDatasetLoader
from .twitter_tennis import TwitterTennisDatasetLoader

__all__ = ["ChickenpoxDatasetLoader", "EnglandCovidDatasetLoader",
           "MontevideoBusDatasetLoader", "PedalMeDatasetLoader",
           "TwitterTennisDatasetLoader"]
