# Development targets (reference analogue: its Makefile runs protoc codegen;
# here there is no codegen — configs are plain dataclasses — so the targets
# are native build, tests, and benchmarks).

.PHONY: native test bench profile docs clean accuracy accuracy_torch \
	profile_torch docs_torch

# Re-run the committed accuracy curves end-to-end on the chip
# (VERDICT r3 #4): CTC hard corpus from scratch, RNN-T medium corpus
# from scratch, RNN-T hard corpus fine-tuned from the medium weights.
# Epoch CSVs land in $(ACC_OUT)/<run>/metrics_epochs.csv (the committed
# copies live in benchmarks/data/).  ~2.5 h total on one v5e chip.
ACC_OUT ?= /tmp/myrtle_accuracy
accuracy:
	python -m myrtlespeech_tpu.run.cli --config configs/synthetic_hard_ctc.py \
	    --checkpoint_dir $(ACC_OUT)/ctc_ckpt --log_dir $(ACC_OUT)/ctc
	python -m myrtlespeech_tpu.run.cli --config configs/synthetic_medium_rnnt.py \
	    --checkpoint_dir $(ACC_OUT)/rnnt_med_ckpt --log_dir $(ACC_OUT)/rnnt_medium
	python -m myrtlespeech_tpu.run.cli --config configs/synthetic_hard_rnnt_ft.py \
	    --init_from $(ACC_OUT)/rnnt_med_ckpt \
	    --checkpoint_dir $(ACC_OUT)/rnnt_hard_ckpt --log_dir $(ACC_OUT)/rnnt_hard
	python tools/accuracy_ab.py --config configs/synthetic_hard_ctc.py \
	    --checkpoint_dir $(ACC_OUT)/ctc_ckpt --family ctc --eval_noise 0.5
	python tools/accuracy_ab.py --config configs/synthetic_medium_rnnt.py \
	    --checkpoint_dir $(ACC_OUT)/rnnt_med_ckpt --family rnnt

# The same recipe through the PyTorch port (myrtlespeech_tpu_torch) on the
# card: the hard CTC corpus from scratch through the port's CLI, then the
# decoder A/Bs of port_tools/ on its checkpoint and on the committed medium
# RNN-T weights, and both convergence checks.  Outputs land in $(ACC_OUT),
# inside the checkout unless given on the command line, so that two
# checkouts run side by side never share a checkpoint; the committed copies
# live in port_tools/accuracy_runs/.
accuracy_torch: ACC_OUT = build/acc_torch
accuracy_torch:
	python port_tools/convergence_check.py
	python port_tools/convergence_check.py --model rnnt
	python -m myrtlespeech_tpu_torch.run.cli \
	    --config myrtlespeech_tpu_torch/configs/synthetic_hard_ctc.py \
	    --checkpoint_dir $(ACC_OUT)/torch_ctc_ckpt --log_dir $(ACC_OUT)/torch_ctc
	python port_tools/accuracy_ab.py \
	    --config myrtlespeech_tpu_torch/configs/synthetic_hard_ctc.py \
	    --checkpoint_dir $(ACC_OUT)/torch_ctc_ckpt --family ctc --eval_noise 0.5
	python port_tools/npz_checkpoint.py \
	    --config myrtlespeech_tpu_torch/configs/synthetic_medium_rnnt.py \
	    --npz benchmarks/data/rnnt_medium/trained_params_bf16.npz \
	    --checkpoint_dir $(ACC_OUT)/torch_rnnt_med_ckpt
	python port_tools/accuracy_ab.py \
	    --config myrtlespeech_tpu_torch/configs/synthetic_medium_rnnt.py \
	    --checkpoint_dir $(ACC_OUT)/torch_rnnt_med_ckpt --family rnnt

docs:
	python tools/gen_api_docs.py

docs_torch:
	python port_tools/gen_api_docs.py

native:
	$(MAKE) -C myrtlespeech_tpu/native

test:
	python -m pytest tests/ -q -n auto

bench:
	python bench.py

profile:
	python tools/profile_step.py --batch 32
	python tools/profile_decode.py --batch 8

# The port's measurement tools on the card (port_tools/).
profile_torch:
	python port_tools/roofline.py --measure
	python port_tools/profile_kernels.py
	python port_tools/profile_step.py --batch 8,16,32
	python port_tools/profile_decode.py --batch 8

clean:
	$(MAKE) -C myrtlespeech_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
