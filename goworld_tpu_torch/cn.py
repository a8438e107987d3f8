# -*- coding: utf-8 -*-
"""goworld_tpu_torch 中文文档入口（对应参考实现的 ``cn/goworld_cn.go``：仅文档与
门面转发，无独立逻辑）。

goworld_tpu_torch 是一个分布式游戏服务器引擎，理论上支持无限横向扩展，是
goworld_tpu 在 PyTorch 与 CUDA 上的移植：AOI（兴趣范围）热点路径整体在
NVIDIA GPU（Hopper，``sm_90a``）上批量计算。

一个部署由三种进程组成：dispatcher、gate、game。

- gate 负责接受客户端连接（TCP、可靠 UDP、WebSocket，支持 TLS 与压缩），
  并维护按属性过滤广播的 filter 树。
- dispatcher 是 game 与 gate 之间的数据转发中心：维护 entity 路由表，
  在实体迁移、进程冻结期间缓存数据包，并做新建实体的负载均衡。
- game 承载全部游戏逻辑，单线程事件驱动（asyncio 主循环），逻辑代码无需
  考虑并发与加锁；任何逻辑都不应调用阻塞的系统调用。

逻辑模型与参考实现一致：场景（Space）与实体（Entity）。客户端登录后在
某个 game 上创建 Account（boot entity），登录成功后创建 Player 并通过
give_client_to 移交客户端。实体可通过 enter_space 在 game 之间无缝迁移
（属性、定时器、客户端绑定全部打包重建）；space 常驻创建它的 game。

与参考实现不同的是 AOI 平面：每个 game 的所有 space 每 tick 合并为一次
PyTorch 步进（ops/neighbor.py），其中的事件核函数是为 Hopper 手写的
CUDA C++ 内核（ops/csrc/event_kernel.cu，由 nvcc 构建、经 ctypes 调用；
在 CPU 张量上改用同一函数的纯 PyTorch 版本）。世界过大时按网格列条带
（parallel/spatial.py）或按实体行（parallel/mesh.py，配置
``[aoi] mesh_shards``）分片到多块 GPU，多个 game 进程之间经
torch.distributed 汇集（parallel/multihost.py）。

运维命令（参考 cmd/goworld；依次为启动部署、热更新（冻结/恢复）、停止、
压测机器人）::

    python -m goworld_tpu_torch.cli start goworld_tpu_torch.examples.test_game
    python -m goworld_tpu_torch.cli reload goworld_tpu_torch.examples.test_game
    python -m goworld_tpu_torch.cli stop goworld_tpu_torch.examples.test_game
    python -m goworld_tpu_torch.client -N 200 -strict          # 压测机器人

本模块将全部公共 API 从 :mod:`goworld_tpu_torch.facade` 原样转发。
"""

from goworld_tpu_torch.facade import *  # noqa: F401,F403
from goworld_tpu_torch.facade import __all__  # noqa: F401
