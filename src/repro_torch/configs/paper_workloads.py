"""The paper's Table I: exemplary DNN layers as GEMM workloads."""

from ..core.analytical import GEMM

WORKLOADS = [
    GEMM(M=64, K=12100, N=147, name="RN0"),     # ResNet50
    GEMM(M=512, K=784, N=128, name="RN1"),
    GEMM(M=128, K=4096, N=2048, name="GNMT0"),  # Google NMT
    GEMM(M=320, K=4096, N=3072, name="GNMT1"),
    GEMM(M=1024, K=50000, N=16, name="DB0"),    # DeepBench
    GEMM(M=35, K=2560, N=4096, name="DB1"),
    GEMM(M=31999, K=84, N=1024, name="TF0"),    # Transformer
    GEMM(M=84, K=4096, N=1024, name="TF1"),
]
