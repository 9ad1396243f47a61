"""The paper's own 'architecture': distributed Power-psi iteration configs."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PsiConfig:
    name: str
    dataset: str = "twitter"       # graphs.datasets key or rmat<scale>
    tol: float = 1e-9
    chunk_iters: int = 16
    dtype: str = "float32"


def config(reduced: bool = False) -> PsiConfig:
    if reduced:
        return PsiConfig(name="psi-reduced", dataset="tiny", chunk_iters=4)
    return PsiConfig(name="psi-score", dataset="twitter")
