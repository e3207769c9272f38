"""Feature stages.

Matrix stages (StandardScaler, MinMaxScaler, MaxAbsScaler, RobustScaler,
PCA, Normalizer, PolynomialExpansion, VectorSlicer, ElementwiseProduct,
Interaction) take an AssembledTable, a DeviceDataset, a tensor or an
ndarray and give back the same kind; their fits run on ``device``
(default the card), a DeviceDataset's where it lies.  Table stages
(Binarizer, Bucketizer, QuantileDiscretizer, StringIndexer,
OneHotEncoder, Imputer, IndexToString, RFormula, VectorSizeHint) are host
numpy over a host Table, as in the JAX package; SQLTransformer runs its
statement through ``core.sql.execute``.  ``VectorAssembler`` stacks a
Table's columns on the host, or a compiled query's columns on the device
(``transform_device``)."""

from .assembler import AssembledTable, VectorAssembler
from .binarizer import Binarizer
from .bucketizer import Bucketizer
from .discretizer import QuantileDiscretizer
from .imputer import Imputer, ImputerModel
from .indexer import StringIndexer, StringIndexerModel
from .minmax import MinMaxScaler, MinMaxScalerModel
from .normalizer import IndexToString, Normalizer, PolynomialExpansion
from .onehot import OneHotEncoder, OneHotEncoderModel
from .pca import PCA, PCAModel
from .rformula import RFormula, RFormulaModel, VectorSizeHint
from .robust import MaxAbsScaler, MaxAbsScalerModel, RobustScaler, RobustScalerModel
from .scaler import StandardScaler, StandardScalerModel
from .sql_transformer import SQLTransformer
from .vector_ops import ElementwiseProduct, Interaction, VectorSlicer

__all__ = [
    "AssembledTable", "Binarizer", "Bucketizer", "ElementwiseProduct", "Imputer",
    "ImputerModel", "IndexToString", "Interaction", "MaxAbsScaler", "MaxAbsScalerModel",
    "MinMaxScaler", "MinMaxScalerModel", "Normalizer", "OneHotEncoder", "OneHotEncoderModel",
    "PCA", "PCAModel", "PolynomialExpansion", "QuantileDiscretizer", "RFormula",
    "RFormulaModel", "RobustScaler", "RobustScalerModel", "SQLTransformer", "StandardScaler",
    "StandardScalerModel", "StringIndexer", "StringIndexerModel", "VectorAssembler",
    "VectorSizeHint", "VectorSlicer",
]
