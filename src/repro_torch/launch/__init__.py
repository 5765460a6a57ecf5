"""Entry points (the torch counterpart of ``repro.launch``): ``serve``,
the batched recsys scoring + DPP rerank driver.
"""
