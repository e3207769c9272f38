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
(``transform_device``).  VectorIndexer, the LSH families, the text stages
(Tokenizer … CountVectorizer, HashingTF, IDF's fit) and FeatureHasher are
host numpy and take no ``device=``; the selectors' fits, IDFModel on a
tensor, DCT and Word2Vec's fit run on ``device`` (default the card)."""

from .assembler import AssembledTable, VectorAssembler
from .binarizer import Binarizer
from .bucketizer import Bucketizer
from .discretizer import QuantileDiscretizer
from .imputer import Imputer, ImputerModel
from .indexer import StringIndexer, StringIndexerModel
from .lsh import (
    BucketedRandomProjectionLSH,
    BucketedRandomProjectionLSHModel,
    MinHashLSH,
    MinHashLSHModel,
)
from .minmax import MinMaxScaler, MinMaxScalerModel
from .normalizer import IndexToString, Normalizer, PolynomialExpansion
from .onehot import OneHotEncoder, OneHotEncoderModel
from .pca import PCA, PCAModel
from .rformula import RFormula, RFormulaModel, VectorSizeHint
from .robust import MaxAbsScaler, MaxAbsScalerModel, RobustScaler, RobustScalerModel
from .scaler import StandardScaler, StandardScalerModel
from .selector import (
    ChiSqSelector,
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorIndexer,
    VectorIndexerModel,
)
from .sql_transformer import SQLTransformer
from .text import (
    DCT,
    IDF,
    CountVectorizer,
    CountVectorizerModel,
    HashingTF,
    IDFModel,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from .vector_ops import ElementwiseProduct, Interaction, VectorSlicer
from .word2vec import FeatureHasher, Word2Vec, Word2VecModel

__all__ = [
    "AssembledTable", "Binarizer", "Bucketizer", "ElementwiseProduct", "Imputer",
    "ImputerModel", "IndexToString", "Interaction", "MaxAbsScaler", "MaxAbsScalerModel",
    "MinMaxScaler", "MinMaxScalerModel", "Normalizer", "OneHotEncoder", "OneHotEncoderModel",
    "PCA", "PCAModel", "PolynomialExpansion", "QuantileDiscretizer", "RFormula",
    "RFormulaModel", "RobustScaler", "RobustScalerModel", "SQLTransformer", "StandardScaler",
    "StandardScalerModel", "StringIndexer", "StringIndexerModel", "VectorAssembler",
    "VectorSizeHint", "VectorSlicer",
    # slice 5d
    "BucketedRandomProjectionLSH", "BucketedRandomProjectionLSHModel", "ChiSqSelector",
    "CountVectorizer", "CountVectorizerModel", "DCT", "FeatureHasher", "HashingTF", "IDF",
    "IDFModel", "MinHashLSH", "MinHashLSHModel", "NGram", "RegexTokenizer", "StopWordsRemover",
    "Tokenizer", "UnivariateFeatureSelector", "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector", "VarianceThresholdSelectorModel", "VectorIndexer",
    "VectorIndexerModel", "Word2Vec", "Word2VecModel",
]
