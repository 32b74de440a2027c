# himo_tpu runtime image (the reference's conda/docker env story,
# README.md:32): JAX with its CUDA 12 plugin for NVIDIA GPUs, plus the
# host-side pipeline (h5 IO, eval, native packer).
FROM nvidia/cuda:12.8.1-cudnn-runtime-ubuntu24.04

RUN apt-get update && apt-get install -y --no-install-recommends \
    python3 python3-pip python3-venv build-essential make g++ \
    && rm -rf /var/lib/apt/lists/*

RUN python3 -m venv /venv
ENV PATH=/venv/bin:$PATH

WORKDIR /opt/himo_tpu
COPY pyproject.toml README.md ./
COPY himo_tpu ./himo_tpu
COPY native ./native
COPY bench.py chip_smoke.py __graft_entry__.py eval.py save_zip.py ./

RUN pip install --no-cache-dir \
    "jax[cuda12]" optax chex einops \
    numpy scipy h5py pandas pyarrow tabulate tqdm scikit-learn opencv-python-headless \
    && pip install --no-cache-dir -e . --no-deps \
    && make -C native

ENTRYPOINT ["python", "-m", "himo_tpu.cli.eval"]
