"""The LM stack (port of ``repro.models``): ``config``, ``layers``,
``attention``, ``moe`` (kernel B3 and the segment kernel on its path),
``rwkv``, ``ssm`` and ``transformer``."""
