"""The paper's own experimental configuration (Section 6.1 defaults).

A copy of ``src/repro/configs/oavi_paper.py`` for the port.  Not an entry of
the LM architecture registry in :mod:`repro_torch.configs`.
"""

from ..core.oavi import OAVIConfig
from ..core.oracles import OracleConfig
from ..core.pipeline import PipelineConfig
from ..core.svm import LinearSVMConfig

PSI_DEFAULT = 0.005       # vanishing parameter used throughout the paper
TAU_DEFAULT = 1000.0      # l1 radius for (CCOP)
EPS_FRAC = 0.01           # solver accuracy = 0.01 * psi
MAX_SOLVER_ITER = 10_000  # paper's hard cap


def cgavi_ihb(psi: float = PSI_DEFAULT) -> OAVIConfig:
    return OAVIConfig(psi=psi, engine="oracle", ihb=True,
                      solver=OracleConfig(name="cg", tau=TAU_DEFAULT,
                                          eps_frac=EPS_FRAC, max_iter=MAX_SOLVER_ITER))


def bpcgavi_wihb(psi: float = PSI_DEFAULT) -> OAVIConfig:
    return OAVIConfig(psi=psi, engine="oracle", ihb=True, wihb=True,
                      solver=OracleConfig(name="bpcg", tau=TAU_DEFAULT,
                                          eps_frac=EPS_FRAC, max_iter=MAX_SOLVER_ITER))


def pipeline(method: str = "cgavi-ihb", psi: float = PSI_DEFAULT) -> PipelineConfig:
    return PipelineConfig(method=method, psi=psi, svm=LinearSVMConfig(lam=1e-4))
