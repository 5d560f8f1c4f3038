// Minimal libibverbs ABI declarations for the dlopen'd verbs backend.
//
// This image ships libibverbs.so.1 but no headers, so the stable
// rdma-core ABI subset we need is declared here directly. Only the
// structs the backend touches are declared; layouts follow rdma-core's
// long-frozen verbs.h ABI (the _compat_* slots in ibv_context_ops are
// the historical ops-table entries that modern rdma-core routes through
// exported symbols instead).
//
// Everything here is accessed strictly at runtime behind dlopen; if the
// library (or a device) is absent, the backend reports failure and the
// engine falls back to "emu".
#ifndef TDR_VERBS_ABI_H_
#define TDR_VERBS_ABI_H_

#include <pthread.h>
#include <stddef.h>
#include <stdint.h>

extern "C" {

struct ibv_device;
struct ibv_context;
struct ibv_comp_channel;
struct ibv_srq;
struct ibv_mw;
struct ibv_ah;

union ibv_gid {
  uint8_t raw[16];
  struct {
    uint64_t subnet_prefix;
    uint64_t interface_id;
  } global;
};

enum ibv_qp_state {
  IBV_QPS_RESET = 0,
  IBV_QPS_INIT = 1,
  IBV_QPS_RTR = 2,
  IBV_QPS_RTS = 3,
  IBV_QPS_ERR = 6,
};

enum ibv_mtu {
  IBV_MTU_256 = 1,
  IBV_MTU_512 = 2,
  IBV_MTU_1024 = 3,
  IBV_MTU_2048 = 4,
  IBV_MTU_4096 = 5,
};

enum ibv_qp_type { IBV_QPT_RC = 2, IBV_QPT_UC = 3, IBV_QPT_UD = 4 };

enum ibv_access_flags {
  IBV_ACCESS_LOCAL_WRITE = 1,
  IBV_ACCESS_REMOTE_WRITE = 2,
  IBV_ACCESS_REMOTE_READ = 4,
  IBV_ACCESS_REMOTE_ATOMIC = 8,
};

enum ibv_wr_opcode {
  IBV_WR_RDMA_WRITE = 0,
  IBV_WR_RDMA_WRITE_WITH_IMM = 1,
  IBV_WR_SEND = 2,
  IBV_WR_SEND_WITH_IMM = 3,
  IBV_WR_RDMA_READ = 4,
};

enum ibv_send_flags {
  IBV_SEND_FENCE = 1,
  IBV_SEND_SIGNALED = 2,
  IBV_SEND_SOLICITED = 4,
  IBV_SEND_INLINE = 8,
};

enum ibv_wc_status { IBV_WC_SUCCESS = 0 };

enum ibv_wc_flags { IBV_WC_GRH = 1 << 0, IBV_WC_WITH_IMM = 1 << 1 };

enum ibv_wc_opcode {
  IBV_WC_SEND = 0,
  IBV_WC_RDMA_WRITE = 1,
  IBV_WC_RDMA_READ = 2,
  IBV_WC_RECV = 1 << 7,
};

/* ibv_modify_qp attr_mask bits */
enum {
  IBV_QP_STATE = 1 << 0,
  IBV_QP_ACCESS_FLAGS = 1 << 3,
  IBV_QP_PKEY_INDEX = 1 << 4,
  IBV_QP_PORT = 1 << 5,
  IBV_QP_AV = 1 << 7,
  IBV_QP_PATH_MTU = 1 << 8,
  IBV_QP_TIMEOUT = 1 << 9,
  IBV_QP_RETRY_CNT = 1 << 10,
  IBV_QP_RNR_RETRY = 1 << 11,
  IBV_QP_RQ_PSN = 1 << 12,
  IBV_QP_MAX_QP_RD_ATOMIC = 1 << 13,
  IBV_QP_MIN_RNR_TIMER = 1 << 15,
  IBV_QP_SQ_PSN = 1 << 16,
  IBV_QP_MAX_DEST_RD_ATOMIC = 1 << 17,
  IBV_QP_CAP = 1 << 19,
  IBV_QP_DEST_QPN = 1 << 20,
};

enum ibv_port_state { IBV_PORT_ACTIVE = 4 };
enum { IBV_LINK_LAYER_INFINIBAND = 1, IBV_LINK_LAYER_ETHERNET = 2 };

struct ibv_global_route {
  union ibv_gid dgid;
  uint32_t flow_label;
  uint8_t sgid_index;
  uint8_t hop_limit;
  uint8_t traffic_class;
};

struct ibv_ah_attr {
  struct ibv_global_route grh;
  uint16_t dlid;
  uint8_t sl;
  uint8_t src_path_bits;
  uint8_t static_rate;
  uint8_t is_global;
  uint8_t port_num;
};

struct ibv_qp_cap {
  uint32_t max_send_wr;
  uint32_t max_recv_wr;
  uint32_t max_send_sge;
  uint32_t max_recv_sge;
  uint32_t max_inline_data;
};

struct ibv_qp_init_attr {
  void *qp_context;
  struct ibv_cq *send_cq;
  struct ibv_cq *recv_cq;
  struct ibv_srq *srq;
  struct ibv_qp_cap cap;
  int qp_type; /* enum ibv_qp_type */
  int sq_sig_all;
};

struct ibv_qp_attr {
  int qp_state;     /* enum ibv_qp_state */
  int cur_qp_state; /* enum ibv_qp_state */
  int path_mtu;     /* enum ibv_mtu */
  int path_mig_state;
  uint32_t qkey;
  uint32_t rq_psn;
  uint32_t sq_psn;
  uint32_t dest_qp_num;
  unsigned int qp_access_flags;
  struct ibv_qp_cap cap;
  struct ibv_ah_attr ah_attr;
  struct ibv_ah_attr alt_ah_attr;
  uint16_t pkey_index;
  uint16_t alt_pkey_index;
  uint8_t en_sqd_async_notify;
  uint8_t sq_draining;
  uint8_t max_rd_atomic;
  uint8_t max_dest_rd_atomic;
  uint8_t min_rnr_timer;
  uint8_t port_num;
  uint8_t timeout;
  uint8_t retry_cnt;
  uint8_t rnr_retry;
  uint8_t alt_port_num;
  uint8_t alt_timeout;
  uint32_t rate_limit;
};

struct ibv_port_attr {
  int state;      /* enum ibv_port_state */
  int max_mtu;    /* enum ibv_mtu */
  int active_mtu; /* enum ibv_mtu */
  int gid_tbl_len;
  uint32_t port_cap_flags;
  uint32_t max_msg_sz;
  uint32_t bad_pkey_cntr;
  uint32_t qkey_viol_cntr;
  uint16_t pkey_tbl_len;
  uint16_t lid;
  uint16_t sm_lid;
  uint8_t lmc;
  uint8_t max_vl_num;
  uint8_t sm_sl;
  uint8_t subnet_timeout;
  uint8_t init_type_reply;
  uint8_t active_width;
  uint8_t active_speed;
  uint8_t phys_state;
  uint8_t link_layer;
  uint8_t flags;
  uint16_t port_cap_flags2;
  uint32_t active_speed_ex;
  /* Slack so newer rdma-core revisions writing extra trailing fields
   * stay within our allocation. */
  uint8_t reserved_[64];
};

struct ibv_sge {
  uint64_t addr;
  uint32_t length;
  uint32_t lkey;
};

struct ibv_send_wr {
  uint64_t wr_id;
  struct ibv_send_wr *next;
  struct ibv_sge *sg_list;
  int num_sge;
  int opcode; /* enum ibv_wr_opcode */
  unsigned int send_flags;
  union {
    uint32_t imm_data;
    uint32_t invalidate_rkey;
  };
  union {
    struct {
      uint64_t remote_addr;
      uint32_t rkey;
    } rdma;
    struct {
      uint64_t remote_addr;
      uint64_t compare_add;
      uint64_t swap;
      uint32_t rkey;
    } atomic;
    struct {
      struct ibv_ah *ah;
      uint32_t remote_qpn;
      uint32_t remote_qkey;
    } ud;
  } wr;
  union {
    struct {
      uint32_t remote_srqn;
    } xrc;
  } qp_type;
  union {
    struct {
      struct ibv_mw *mw;
      uint32_t rkey;
      uint8_t bind_info_[40]; /* struct ibv_mw_bind_info, unused here */
    } bind_mw;
    struct {
      void *hdr;
      uint16_t hdr_sz;
      uint16_t mss;
    } tso;
  };
};

struct ibv_recv_wr {
  uint64_t wr_id;
  struct ibv_recv_wr *next;
  struct ibv_sge *sg_list;
  int num_sge;
};

struct ibv_wc {
  uint64_t wr_id;
  int status; /* enum ibv_wc_status */
  int opcode; /* enum ibv_wc_opcode */
  uint32_t vendor_err;
  uint32_t byte_len;
  union {
    uint32_t imm_data;
    uint32_t invalidated_rkey;
  };
  uint32_t qp_num;
  uint32_t src_qp;
  unsigned int wc_flags;
  uint16_t pkey_index;
  uint16_t slid;
  uint8_t sl;
  uint8_t dlid_path_bits;
};

struct ibv_pd {
  struct ibv_context *context;
  uint32_t handle;
};

struct ibv_mr {
  struct ibv_context *context;
  struct ibv_pd *pd;
  void *addr;
  size_t length;
  uint32_t handle;
  uint32_t lkey;
  uint32_t rkey;
};

struct ibv_cq {
  struct ibv_context *context;
  struct ibv_comp_channel *channel;
  void *cq_context;
  uint32_t handle;
  int cqe;
  pthread_mutex_t mutex;
  pthread_cond_t cond;
  uint32_t comp_events_completed;
  uint32_t async_events_completed;
};

struct ibv_qp {
  struct ibv_context *context;
  void *qp_context;
  struct ibv_pd *pd;
  struct ibv_cq *send_cq;
  struct ibv_cq *recv_cq;
  struct ibv_srq *srq;
  uint32_t handle;
  uint32_t qp_num;
  int state;   /* enum ibv_qp_state */
  int qp_type; /* enum ibv_qp_type */
  pthread_mutex_t mutex;
  pthread_cond_t cond;
  uint32_t events_completed;
};

/* The legacy ops table embedded in ibv_context. The named non-compat
 * entries (poll_cq, post_send, post_recv) are the device-driver fast
 * paths; their slot positions are ABI-frozen. */
struct ibv_context_ops {
  void *(*_compat_query_device)(void);
  int (*_compat_query_port)(struct ibv_context *, uint8_t, void *);
  void *(*_compat_alloc_pd)(void);
  void *(*_compat_dealloc_pd)(void);
  void *(*_compat_reg_mr)(void);
  void *(*_compat_rereg_mr)(void);
  void *(*_compat_dereg_mr)(void);
  void *(*alloc_mw)(void);
  void *(*bind_mw)(void);
  void *(*dealloc_mw)(void);
  void *(*_compat_create_cq)(void);
  int (*poll_cq)(struct ibv_cq *, int, struct ibv_wc *);
  int (*req_notify_cq)(struct ibv_cq *, int);
  void *(*_compat_cq_event)(void);
  void *(*_compat_resize_cq)(void);
  void *(*_compat_destroy_cq)(void);
  void *(*_compat_create_srq)(void);
  void *(*_compat_modify_srq)(void);
  void *(*_compat_query_srq)(void);
  void *(*_compat_destroy_srq)(void);
  int (*post_srq_recv)(struct ibv_srq *, struct ibv_recv_wr *,
                       struct ibv_recv_wr **);
  void *(*_compat_create_qp)(void);
  void *(*_compat_query_qp)(void);
  void *(*_compat_modify_qp)(void);
  void *(*_compat_destroy_qp)(void);
  int (*post_send)(struct ibv_qp *, struct ibv_send_wr *,
                   struct ibv_send_wr **);
  int (*post_recv)(struct ibv_qp *, struct ibv_recv_wr *,
                   struct ibv_recv_wr **);
  void *(*_compat_create_ah)(void);
  void *(*_compat_destroy_ah)(void);
  void *(*_compat_attach_mcast)(void);
  void *(*_compat_detach_mcast)(void);
  void *(*_compat_async_event)(void);
};

struct ibv_context {
  struct ibv_device *device;
  struct ibv_context_ops ops;
  int cmd_fd;
  int async_fd;
  int num_comp_vectors;
  pthread_mutex_t mutex;
  void *abi_compat;
};

/* dlsym'd entry points (all exported by libibverbs.so.1). */
typedef struct ibv_device **(*fn_ibv_get_device_list)(int *);
typedef void (*fn_ibv_free_device_list)(struct ibv_device **);
typedef const char *(*fn_ibv_get_device_name)(struct ibv_device *);
typedef struct ibv_context *(*fn_ibv_open_device)(struct ibv_device *);
typedef int (*fn_ibv_close_device)(struct ibv_context *);
typedef struct ibv_pd *(*fn_ibv_alloc_pd)(struct ibv_context *);
typedef int (*fn_ibv_dealloc_pd)(struct ibv_pd *);
typedef struct ibv_mr *(*fn_ibv_reg_mr)(struct ibv_pd *, void *, size_t, int);
typedef struct ibv_mr *(*fn_ibv_reg_dmabuf_mr)(struct ibv_pd *, uint64_t,
                                               size_t, uint64_t, int, int);
typedef int (*fn_ibv_dereg_mr)(struct ibv_mr *);
typedef struct ibv_cq *(*fn_ibv_create_cq)(struct ibv_context *, int, void *,
                                           struct ibv_comp_channel *, int);
typedef int (*fn_ibv_destroy_cq)(struct ibv_cq *);
typedef struct ibv_qp *(*fn_ibv_create_qp)(struct ibv_pd *,
                                           struct ibv_qp_init_attr *);
typedef int (*fn_ibv_modify_qp)(struct ibv_qp *, struct ibv_qp_attr *, int);
typedef int (*fn_ibv_destroy_qp)(struct ibv_qp *);
typedef int (*fn_ibv_query_port)(struct ibv_context *, uint8_t,
                                 struct ibv_port_attr *);
typedef int (*fn_ibv_query_gid)(struct ibv_context *, uint8_t, int,
                                union ibv_gid *);

}  // extern "C"

#endif  // TDR_VERBS_ABI_H_
