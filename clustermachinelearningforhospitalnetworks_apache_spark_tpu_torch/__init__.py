"""PyTorch + CUDA port of the hospital-network ML framework.

Mirrors the JAX package's module paths and public names.  Slice 1 covers
the KMeans k=256 path: Table → VectorAssembler → StandardScaler → KMeans
fit/predict → silhouette, and the online server that answers requests
with the fitted model.  Slice 2 covers the hospital pipeline's model
stage: CSV → Binarizer → seed-42 split → VectorAssembler →
LinearRegression, decision-tree and random-forest regressors and
classifiers → RMSE, accuracy and feature importances.  Models save to
and load from the JAX package's artifact layout (``io/model_io.py``:
``model.write().overwrite().save(path)``, ``load_model(path)``), so a
model fitted by either package serves from the other.  Slice 3b covers
the SQL training window: the parser, the planner and the numpy
interpreter, with the compiled executor running fully supported
single-table plans as torch ops over columns on the card
(``sql_execute``, ``sql_explain``, ``extract_training_window``).  Slice
3c covers ingest and the whole job: CSV files streamed through the
watermark into the checkpointed, exactly-once unbounded table
(``Session``, ``read_stream … write_stream … table``, ``StreamExecution``),
the window through ``Session.sql``, the model stage, plots, saves and the
report (``run_pipeline``; the ``hospital-pipeline-torch`` console entry).
Slices 4a–4c add the other clusterings (StreamingKMeans, GaussianMixture,
BisectingKMeans), the out-of-core fits (``HostDataset``) and KMeans' and
GaussianMixture's reduced-precision modes; slice 3e the gradient-boosted
trees (``GBTRegressor``, ``GBTClassifier``) and LinearRegression's elastic
net and training summary.  Slice 5a adds the ``LOS_binary`` classifiers:
LogisticRegression (binomial and multinomial, resident and out of core)
with its training summaries and ROC / PR curves,
BinaryClassificationEvaluator, LinearSVC, NaiveBayes, OneVsRest, and the
composites ``Pipeline`` / ``PipelineModel``, ``CrossValidator`` and
``TrainValidationSplit``.  Slice 5b adds the L-BFGS, Adam and IRLS
families: GeneralizedLinearRegression (five families, its training
summary, out of core), MultilayerPerceptronClassifier and
AFTSurvivalRegression on the port's own ``optax.lbfgs`` steps
(``models/_opt.py``), FMRegressor / FMClassifier, IsotonicRegression,
StreamingLinearRegression / StreamingLogisticRegression, and ``stat``
(``pyspark.ml.stat``).  Slice 5c adds the tabular feature stages
(Bucketizer, QuantileDiscretizer, StringIndexer, OneHotEncoder, Imputer,
MinMax / MaxAbs / Robust scalers, PCA, Normalizer, PolynomialExpansion,
IndexToString, VectorSlicer, ElementwiseProduct, Interaction, RFormula,
VectorSizeHint, SQLTransformer), LIBSVM files, and the fused
SQL-to-device path: ``Session.sql_to_device`` runs a compiled window
query as torch ops and stacks its columns into a ``DeviceDataset`` on the
card with no host round trip (``VectorAssembler.transform_device``,
``compact=True`` for exactly the valid rows).  Every subpackage re-exports
its public names as the JAX package's does, but for the modules still to
port.  Its CPU tests: ``python -m pytest tests/test_torch_feature_stages.py
tests/test_torch_rformula.py tests/test_torch_libsvm.py
tests/test_torch_sql_device.py tests/test_torch_imports.py``; they hold
the fused path to the JAX package's host route (interpreter, ``na_drop``,
``VectorAssembler``), because the JAX package's own fused assembly
imports ``jax.experimental.enable_x64``, which some jax versions lack.
On a card, ``chip_smoke.features_phase(port, L, H, card)`` runs the slice
alone after ``ops._build.build()``.  Slices 5d and 5e add the selectors
(VectorIndexer, UnivariateFeatureSelector, ChiSqSelector,
VarianceThresholdSelector), the LSH families, the text stages (Tokenizer
… CountVectorizer, HashingTF, IDF, DCT), Word2Vec and FeatureHasher, ALS
with RankingEvaluator and MultilabelClassificationEvaluator, LDA,
PowerIterationClustering, FPGrowth and PrefixSpan.  Where the JAX package
computes in numpy the port does too and takes no ``device=``; the fits and
transforms it computes in jax run on ``device=`` here (default the card).
Their CPU tests: ``python -m pytest tests/test_torch_selectors.py
tests/test_torch_lsh.py tests/test_torch_text.py tests/test_torch_word2vec.py
tests/test_torch_als.py tests/test_torch_lda_pic.py tests/test_torch_fpm.py
tests/test_torch_ranking_eval.py``; on a card,
``chip_smoke.beyond_phase(port, L, H, card)`` runs them alone after
``ops._build.build()``.  Slice 6 adds the table's history: materialized
views (``Session.create_view``; ``core/sql_views.py``) folded per
committed batch on the card and served by ``Session.sql`` (route
``"view"``), sealed segments with CRC32C records and zone maps
(``core/segments.py``) that the compiled scan prunes by, the seal /
retire / scrub lifecycle (``core/table_lifecycle.py``, host work), and
the fuzz harness (``core/sql_fuzz.py``: ``run_fuzz``,
``run_fuzz_incremental`` on ``device=``).  Its CPU tests: ``python -m
pytest tests/test_torch_segments.py tests/test_torch_table_lifecycle.py
tests/test_torch_sql_views.py tests/test_torch_sql_fuzz.py``; on a card,
``chip_smoke.history_phase(port, H, card)`` runs it alone after
``ops._build.build()``.  Slice 7a adds the serving front door and its host
subsystems: ``tune/`` (the knob registry, the durable trial store, the
selector with its A/B fence, the journaled live retuner), ``quality/``
(sketches and PSI, row validators, header reconciliation, the drift
monitor and input guard, the ``DataFirewall`` with the salvage CSV parser
and the stream's row quarantine), and the server's circuit breaker, input
and drift guards, hot swaps, ``health()`` and ``metrics_text()``.  The
quality stages, the firewall and the tuner are host code and take no
``device=``; the server takes its device as before.  Its CPU tests:
``python -m pytest tests/test_torch_quality.py tests/test_torch_autotune.py
tests/test_torch_breaker.py tests/test_torch_firewall.py
tests/test_torch_serving.py``; on a card,
``chip_smoke.front_door_phase(port, L, card)`` runs it alone after
``ops._build.build()``.  Slice 7b adds the model farm (``farm/``: one model
per hospital, fit for every hospital at once on the card, bit-equal to a
loop over the hospitals, served from one artifact through
``InferenceServer.predict_tenant``) and the continuous-learning lifecycle
(``lifecycle/``: the journaled controller that detects drift,
warm-retrains, shadow-scores, canary-routes and promotes or rolls back,
surviving a kill at any transition).  Packing, the tenant sketches, the
journal, the feedback spool and the gates are host code.  Its CPU tests:
``python -m pytest tests/test_torch_farm.py tests/test_torch_lifecycle.py``;
on a card, ``chip_smoke.farm_lifecycle_phase(port, L, card)`` runs it alone
after ``ops._build.build()``.  Slice 7c adds the serving fleet
(``serve.fleet``) and cross-silo federation (``federated/``: silos compute
the partials of LinearRegression, KMeans and GaussianMixture on their
device, a journaled coordinator merges them in ascending silo order and
fits on its device); slice 7d the pipelined stream
(``streaming.PipelinedStreamExecution``, ``ModelUpdateConsumer``) and the
profiling hooks (``utils.profiling``: ``StageClock``, the host-sync census,
``capture_trace`` over ``torch.profiler``).  Their CPU tests: ``python -m
pytest tests/test_torch_federated.py tests/test_torch_stream_pipeline.py``;
on a card, ``chip_smoke.federated_phase(port, ops, L, card)`` and
``chip_smoke.pipeline_stream_phase(port, ops, L, card)`` run them alone
after ``ops._build.build()``.  Slice 7d-2 adds the compressed-production-day
soak (``soak``, imported on its own as in the JAX package: ``run_soak``
and ``python -m <package>.soak``), one seeded day of every subsystem under
chaos judged by a machine-checked report.  Its CPU tests: ``python -m
pytest tests/test_torch_soak.py``; on a card,
``chip_smoke.soak_phase(port, card)`` runs it alone.  Slice 8a adds the
mesh (``parallel``: ``MeshConfig``, ``build_mesh`` / ``build_hybrid_mesh`` /
``default_mesh`` / ``use_mesh``, the ``torch.distributed`` runtime, the
partitioner, sharded datasets, the ordered collectives and the per-hospital
placement ``federated_dataset``) and runs KMeans over it: fit, predict,
cost and silhouette on a (data, model) mesh in one process and across
processes (``KMeans().fit(x, mesh=build_mesh(MeshConfig(data=4)))``).
Its CPU tests: ``python -m pytest tests/test_torch_mesh.py
tests/test_torch_sharded_kmeans.py tests/test_torch_distributed.py
tests/test_torch_hospital_placement.py``; on a card,
``chip_smoke.mesh_phase(port, L, card, ds, model, init)`` runs it after
the main path.  Slice 8b-1 runs the reference script's model stage over
the mesh: ``Session(mesh=)`` (else the one-entry mesh of ``device=``, else
``build_mesh(config.mesh)`` over every card), ``run_model_stage(...,
mesh=)``, and ``fit`` / ``transform`` with ``mesh=`` on LinearRegression,
the decision trees, random forests, GBT (K3 once a data shard a level),
GaussianMixture and LogisticRegression, each shard's statistics summed in
ascending shard order.  Slices 8c-1 to 8c-3 bring the clustering family,
out of core, the other estimators and the composites (``Pipeline``,
``CrossValidator``, ``TrainValidationSplit``: ``fit(data, label_col,
mesh)``); what is left (PCA, the selectors, LDA, PIC, ALS) raises for more
than one shard, naming slice 8c-4.  Its CPU tests: ``python -m pytest
tests/test_torch_sharded_models.py tests/test_torch_sharded_pipeline.py
tests/test_torch_distributed.py``; on a card, ``chip_smoke.py``'s
``mesh_models_phase``.
Hand-written
Hopper kernels (``csrc/``) carry the Lloyd step, the assignment and the
trees' level histograms on the card; entry points default to
``device="cuda"`` and run on the CPU only when asked.
"""

from . import (farm, federated, models, parallel, pipeline, quality, serve, stat, streaming, tune,
               tuning, utils, viz)
from .config import MeshConfig, PipelineConfig
from .convert import (
    imputer_model_from_jax_arrays,
    maxabs_scaler_model_from_jax_arrays,
    minmax_scaler_model_from_jax_arrays,
    one_hot_encoder_model_from_jax_arrays,
    pca_model_from_jax_arrays,
    rformula_model_from_jax_arrays,
    robust_scaler_model_from_jax_arrays,
    string_indexer_model_from_jax_arrays,
    als_model_from_jax_arrays,
    bucketed_random_projection_lsh_model_from_jax_arrays,
    count_vectorizer_model_from_jax_arrays,
    idf_model_from_jax_arrays,
    lda_model_from_jax_arrays,
    minhash_lsh_model_from_jax_arrays,
    univariate_feature_selector_model_from_jax_arrays,
    variance_threshold_selector_model_from_jax_arrays,
    vector_indexer_model_from_jax_arrays,
    word2vec_model_from_jax_arrays,
    aft_model_from_jax_arrays,
    fm_model_from_jax_arrays,
    glm_model_from_jax_arrays,
    isotonic_model_from_jax_arrays,
    mlp_model_from_jax_arrays,
    streaming_linear_regression_from_jax_arrays,
    streaming_logistic_regression_from_jax_arrays,
    bisecting_kmeans_model_from_jax_arrays,
    gaussian_mixture_model_from_jax_arrays,
    gbt_model_from_jax_arrays,
    kmeans_model_from_jax_arrays,
    linear_regression_model_from_jax_arrays,
    linear_svc_model_from_jax_arrays,
    logistic_regression_model_from_jax_arrays,
    multinomial_logistic_regression_model_from_jax_arrays,
    naive_bayes_model_from_jax_arrays,
    scaler_model_from_jax_arrays,
    streaming_kmeans_model_from_jax_arrays,
    tree_model_from_jax_arrays,
)
from .core.schema import FEATURE_COLS, LABEL_COL, Field, Schema, hospital_event_schema
from .core.split import random_split, split_indices, train_test_split
from .core.sql import execute as sql_execute
from .core.sql import explain as sql_explain
from .core.table import Table
from .data import DeviceDataset, device_dataset
from .device import resolve_device
from .evaluation.binary import BinaryClassificationEvaluator, binary_curves
from .evaluation.classification import MulticlassClassificationEvaluator
from .evaluation.clustering import ClusteringEvaluator
from .evaluation.ranking import MultilabelClassificationEvaluator, RankingEvaluator
from .evaluation.regression import RegressionEvaluator
from .features import (
    DCT,
    IDF,
    PCA,
    AssembledTable,
    Binarizer,
    Bucketizer,
    BucketedRandomProjectionLSH,
    BucketedRandomProjectionLSHModel,
    ChiSqSelector,
    CountVectorizer,
    CountVectorizerModel,
    ElementwiseProduct,
    FeatureHasher,
    HashingTF,
    IDFModel,
    Imputer,
    ImputerModel,
    IndexToString,
    Interaction,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinHashLSH,
    MinHashLSHModel,
    MinMaxScalerModel,
    NGram,
    Normalizer,
    OneHotEncoder,
    OneHotEncoderModel,
    PCAModel,
    PolynomialExpansion,
    QuantileDiscretizer,
    RegexTokenizer,
    RFormula,
    RFormulaModel,
    RobustScaler,
    RobustScalerModel,
    SQLTransformer,
    StandardScaler,
    StandardScalerModel,
    StopWordsRemover,
    StringIndexer,
    StringIndexerModel,
    Tokenizer,
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorAssembler,
    VectorIndexer,
    VectorIndexerModel,
    VectorSizeHint,
    VectorSlicer,
    Word2Vec,
    Word2VecModel,
)
from .io.csv import read_csv, read_csv_dir, write_csv
from .io.libsvm import read_libsvm, write_libsvm
from .io.fit_checkpoint import FitCheckpointer
from .io.model_io import CorruptArtifactError, load_model
from .models.aft import AFTSurvivalRegression, AFTSurvivalRegressionModel
from .models.als import ALS, ALSModel
from .models.base import PredictionResult
from .models.bisecting_kmeans import BisectingKMeans, BisectingKMeansModel
from .models.fm import FMClassifier, FMModel, FMRegressor
from .models.fpm import FPGrowth, FPGrowthModel, PrefixSpan
from .models.glm import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
    GeneralizedLinearRegressionTrainingSummary,
)
from .models.gmm import GaussianMixture, GaussianMixtureModel
from .models.isotonic import IsotonicRegression, IsotonicRegressionModel
from .models.kmeans import KMeans, KMeansModel
from .models.lda import LDA, LDAModel
from .models.linear_regression import LinearRegression, LinearRegressionModel
from .models.linear_svc import LinearSVC, LinearSVCModel
from .models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    MultinomialLogisticRegressionModel,
)
from .models.mlp import MultilayerPerceptronClassifier, MultilayerPerceptronModel
from .models.naive_bayes import NaiveBayes, NaiveBayesModel
from .models.one_vs_rest import OneVsRest, OneVsRestModel
from .models.pic import PowerIterationClustering
from .models.summary import (
    BinaryLogisticRegressionTrainingSummary,
    MulticlassLogisticRegressionTrainingSummary,
)
from .models.streaming_kmeans import StreamingKMeans, StreamingKMeansModel
from .models.streaming_linear import StreamingLinearRegression, StreamingLogisticRegression
from .models.tree import (
    DecisionTreeClassifier,
    DecisionTreeModel,
    DecisionTreeRegressor,
    GBTClassifier,
    GBTModel,
    GBTRegressor,
    RandomForestClassifier,
    RandomForestModel,
    RandomForestRegressor,
)
from .parallel.federation import FederatedDataset, federated_dataset
from .parallel.mesh import build_hybrid_mesh, build_mesh, default_mesh, use_mesh
from .parallel.outofcore import HostDataset
from .pipeline.ml_pipeline import Pipeline, PipelineModel, load_pipeline_model
from .pipeline.hospital_pipeline import (
    PipelineResult,
    StageResult,
    extract_training_window,
    run_model_stage,
    run_pipeline,
)
from .quality import (
    ConstraintSet,
    DataFirewall,
    DataProfile,
    DriftMonitor,
    InputGuard,
    RowValidator,
    hospital_constraints,
)
from .session import Session
from .stat import (
    ANOVATest,
    ChiSquareTest,
    ChiSquareTestResult,
    Correlation,
    FTestResult,
    FValueTest,
    KolmogorovSmirnovTest,
    KolmogorovSmirnovTestResult,
    Summarizer,
    SummaryStats,
)
from .streaming import (
    FileStreamSource,
    StreamCheckpoint,
    StreamExecution,
    UnboundedTable,
    WatermarkTracker,
)
from .tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from .version import __version__

__all__ = [
    "AssembledTable", "Binarizer", "BisectingKMeans", "BisectingKMeansModel",
    "ClusteringEvaluator", "GaussianMixture", "GaussianMixtureModel",
    "StreamingKMeans", "StreamingKMeansModel",
    "bisecting_kmeans_model_from_jax_arrays", "gaussian_mixture_model_from_jax_arrays",
    "gbt_model_from_jax_arrays",
    "streaming_kmeans_model_from_jax_arrays", "CorruptArtifactError",
    "DecisionTreeClassifier",
    "DecisionTreeModel", "DecisionTreeRegressor", "DeviceDataset", "FEATURE_COLS",
    "Field", "FitCheckpointer", "GBTClassifier", "GBTModel", "GBTRegressor",
    "HostDataset", "KMeans", "KMeansModel", "LABEL_COL",
    "LinearRegression",
    "LinearRegressionModel", "MulticlassClassificationEvaluator", "PipelineConfig",
    "FileStreamSource", "PipelineResult",
    "PredictionResult", "RandomForestClassifier", "RandomForestModel",
    "RandomForestRegressor", "RegressionEvaluator", "Schema", "Session", "StageResult",
    "StandardScaler", "StandardScalerModel", "StreamCheckpoint", "StreamExecution",
    "Table", "UnboundedTable", "VectorAssembler", "WatermarkTracker",
    "__version__", "device_dataset", "extract_training_window", "hospital_event_schema",
    "kmeans_model_from_jax_arrays", "linear_regression_model_from_jax_arrays",
    "load_model", "random_split", "read_csv", "read_csv_dir", "resolve_device", "run_model_stage",
    "run_pipeline", "write_csv",
    "scaler_model_from_jax_arrays", "serve", "split_indices", "sql_execute", "sql_explain",
    "train_test_split",
    "tree_model_from_jax_arrays",
    # slice 5a
    "BinaryClassificationEvaluator", "BinaryLogisticRegressionTrainingSummary",
    "CrossValidator", "CrossValidatorModel", "LinearSVC", "LinearSVCModel",
    "LogisticRegression", "LogisticRegressionModel",
    "MulticlassLogisticRegressionTrainingSummary", "MultinomialLogisticRegressionModel",
    "NaiveBayes", "NaiveBayesModel", "OneVsRest", "OneVsRestModel", "ParamGridBuilder",
    "Pipeline", "PipelineModel", "TrainValidationSplit", "TrainValidationSplitModel",
    "binary_curves", "linear_svc_model_from_jax_arrays",
    "load_pipeline_model", "logistic_regression_model_from_jax_arrays",
    "multinomial_logistic_regression_model_from_jax_arrays",
    "naive_bayes_model_from_jax_arrays", "viz",
    # slice 5b
    "AFTSurvivalRegression", "AFTSurvivalRegressionModel", "FMClassifier", "FMModel",
    "FMRegressor", "GeneralizedLinearRegression", "GeneralizedLinearRegressionModel",
    "GeneralizedLinearRegressionTrainingSummary", "IsotonicRegression",
    "IsotonicRegressionModel", "MultilayerPerceptronClassifier", "MultilayerPerceptronModel",
    "StreamingLinearRegression", "StreamingLogisticRegression", "aft_model_from_jax_arrays",
    "fm_model_from_jax_arrays", "glm_model_from_jax_arrays", "isotonic_model_from_jax_arrays",
    "mlp_model_from_jax_arrays", "stat", "streaming_linear_regression_from_jax_arrays",
    "streaming_logistic_regression_from_jax_arrays",
    # the package surfaces: the stat names and the subpackages
    "ANOVATest", "ChiSquareTest", "ChiSquareTestResult", "Correlation", "FTestResult",
    "FValueTest", "KolmogorovSmirnovTest", "KolmogorovSmirnovTestResult", "Summarizer",
    "SummaryStats", "models", "pipeline", "streaming", "tuning", "utils",
    # slice 5c
    "Bucketizer", "ElementwiseProduct", "Imputer", "ImputerModel", "IndexToString",
    "Interaction", "MaxAbsScaler", "MaxAbsScalerModel", "MinMaxScaler", "MinMaxScalerModel",
    "Normalizer", "OneHotEncoder", "OneHotEncoderModel", "PCA", "PCAModel",
    "PolynomialExpansion", "QuantileDiscretizer", "RFormula", "RFormulaModel", "RobustScaler",
    "RobustScalerModel", "SQLTransformer", "StringIndexer", "StringIndexerModel",
    "VectorSizeHint", "VectorSlicer", "imputer_model_from_jax_arrays",
    "maxabs_scaler_model_from_jax_arrays", "minmax_scaler_model_from_jax_arrays",
    "one_hot_encoder_model_from_jax_arrays", "pca_model_from_jax_arrays", "read_libsvm",
    "rformula_model_from_jax_arrays", "robust_scaler_model_from_jax_arrays",
    "string_indexer_model_from_jax_arrays", "write_libsvm",
    # slices 5d + 5e
    "ALS", "ALSModel", "BucketedRandomProjectionLSH", "BucketedRandomProjectionLSHModel",
    "ChiSqSelector", "CountVectorizer", "CountVectorizerModel", "DCT", "FPGrowth",
    "FPGrowthModel", "FeatureHasher", "HashingTF", "IDF", "IDFModel", "LDA", "LDAModel",
    "MinHashLSH", "MinHashLSHModel", "MultilabelClassificationEvaluator", "NGram",
    "PowerIterationClustering", "PrefixSpan", "RankingEvaluator", "RegexTokenizer",
    "StopWordsRemover", "Tokenizer", "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel", "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel", "VectorIndexer", "VectorIndexerModel", "Word2Vec",
    "Word2VecModel", "als_model_from_jax_arrays",
    "bucketed_random_projection_lsh_model_from_jax_arrays",
    "count_vectorizer_model_from_jax_arrays", "idf_model_from_jax_arrays",
    "lda_model_from_jax_arrays", "minhash_lsh_model_from_jax_arrays",
    "univariate_feature_selector_model_from_jax_arrays",
    "variance_threshold_selector_model_from_jax_arrays",
    "vector_indexer_model_from_jax_arrays", "word2vec_model_from_jax_arrays",
    # slice 7a
    "ConstraintSet", "DataFirewall", "DataProfile", "DriftMonitor", "InputGuard",
    "RowValidator", "hospital_constraints", "quality",
    # slice 7b
    "farm",
    # slice 8a
    "FederatedDataset", "MeshConfig", "build_hybrid_mesh", "build_mesh", "default_mesh",
    "federated_dataset", "use_mesh",
]
