"""Serving example with the PyTorch port: batched prefill + greedy decode
loop for any LM arch, on the card by default.

The default model is the arch's ``smoke_config`` (as the reference's
examples/serve_lm.py); --full takes the published config (Mamba2-780m:
~0.86 G parameters, ~3.4 GB in fp32).  --conv-impl engine runs Mamba's
prefill conv on the 1D Winograd engine (TPU kernel 9's port; CPU tensors
take its plain version).  Weights are random, from --seed.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-780m --tokens 16 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import data as D
from repro_torch.configs import LMS, smoke_config
from repro_torch.models import lm
from repro_torch.models import ssm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b", choices=sorted(LMS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="the published config (default: smoke_config)")
    ap.add_argument("--conv-impl", default="direct", choices=["direct", "engine"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = LMS[args.arch] if args.full else smoke_config(args.arch)
    ssm.set_conv_impl(args.conv_impl)
    params = lm.lm_init(cfg, seed=args.seed, device=dev)
    max_len = args.prompt_len + args.tokens + 1

    if cfg.frontend == "stub_embeds":
        prompt = {"embeds": D.embed_batch(0, 0, args.batch, args.prompt_len, cfg.d_model, device=dev)}
    else:
        prompt = {"tokens": D.lm_batch(0, 0, args.batch, args.prompt_len, cfg.vocab, device=dev)["tokens"]}

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, prompt, q_chunk=32, max_len=max_len)
        sync()
        print(f"prefill {args.batch}x{args.prompt_len}: {time.perf_counter() - t0:.2f}s")

        out_tokens = []
        tok = torch.argmax(logits, -1)[:, None]
        t0 = time.perf_counter()
        for i in range(args.tokens):
            if cfg.frontend == "stub_embeds":
                # the stub frontend's embedding of the next position
                step_in = D.embed_batch(1, i, args.batch, 1, cfg.d_model, device=dev)
            else:
                step_in = tok
            logits, cache = lm.decode_step(params, cfg, cache, step_in, args.prompt_len + i)
            tok = torch.argmax(logits, -1)[:, None]
            out_tokens.append(tok)
        sync()
        dt = (time.perf_counter() - t0) / args.tokens
    print(f"decode: {dt * 1e3:.1f} ms/token/batch  ({args.batch / dt:.1f} tok/s aggregate)")
    seqs = torch.cat(out_tokens, dim=1)
    print("sampled token ids (greedy):")
    for b in range(args.batch):
        print(" ", seqs[b].tolist())


if __name__ == "__main__":
    main()
