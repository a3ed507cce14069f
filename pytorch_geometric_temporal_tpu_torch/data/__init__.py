"""Dataset loaders: the five datasets bundled with the package (Chickenpox,
PedalMe, England Covid, Montevideo bus, Twitter tennis) and the twelve whose
files are resolved through the data search path (METR-LA, PEMS-BAY, PeMS
all-California and All-LA, WikiMaths, three Windmill sets, MTM, three
synthetic PDE sets) — the JAX package's 17 names."""

from .chickenpox import ChickenpoxDatasetLoader
from .encovid import EnglandCovidDatasetLoader
from .metr_la import METRLADatasetLoader
from .montevideo_bus import MontevideoBusDatasetLoader
from .mtm import MTMDatasetLoader
from .pedalme import PedalMeDatasetLoader
from .pems import PemsAllLADatasetLoader, PemsDatasetLoader
from .pems_bay import PemsBayDatasetLoader
from .synthetic_pde import (
    AdvectionDiffusionDatasetLoader,
    SIDiffusionDatasetLoader,
    WaveEquationDatasetLoader,
)
from .twitter_tennis import TwitterTennisDatasetLoader
from .wikimath import WikiMathsDatasetLoader
from .windmill import (
    WindmillOutputLargeDatasetLoader,
    WindmillOutputMediumDatasetLoader,
    WindmillOutputSmallDatasetLoader,
)

__all__ = [
    "ChickenpoxDatasetLoader",
    "EnglandCovidDatasetLoader",
    "METRLADatasetLoader",
    "MontevideoBusDatasetLoader",
    "MTMDatasetLoader",
    "PedalMeDatasetLoader",
    "PemsAllLADatasetLoader",
    "PemsDatasetLoader",
    "PemsBayDatasetLoader",
    "AdvectionDiffusionDatasetLoader",
    "SIDiffusionDatasetLoader",
    "WaveEquationDatasetLoader",
    "TwitterTennisDatasetLoader",
    "WikiMathsDatasetLoader",
    "WindmillOutputLargeDatasetLoader",
    "WindmillOutputMediumDatasetLoader",
    "WindmillOutputSmallDatasetLoader",
]
